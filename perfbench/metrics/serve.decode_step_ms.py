"""serve.decode_step_ms: device ms of a decode step, the sum of
``SlotScheduler.chunk_ms`` (CUDA events around each decode chunk's
dispatch) over the window's chunks, per step."""


def read(obs):
    if obs.get("kind") != "serve" or not obs["chunk_ms"]:
        return None
    return sum(obs["chunk_ms"]) / (len(obs["chunk_ms"]) * obs["decode_chunk"])
