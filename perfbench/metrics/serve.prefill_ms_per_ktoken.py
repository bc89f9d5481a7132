"""serve.prefill_ms_per_ktoken: device ms of the window's prefill chunks
(``SlotScheduler.prefill_chunk_ms()``) per thousand prompt tokens
prefilled (prompts whose first token came in the window, less a shared
prompt the prefix cache served)."""


def read(obs):
    if obs.get("kind") != "serve" or not obs["prefill_ms"]:
        return None
    tokens = sum(len(r.prompt) - (r.shared_len if hit else 0)
                 for r, hit in obs["prefilled"])
    if tokens <= 0:
        return None
    return sum(obs["prefill_ms"]) / (tokens / 1000.0)
