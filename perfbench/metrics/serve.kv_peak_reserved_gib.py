"""serve.kv_peak_reserved_gib: the KV pool's peak reserved bytes
(``EngineStats.kv_peak_reserved_bytes``) in GiB."""


def read(obs):
    if obs.get("kind") != "serve":
        return None
    return obs["kv_peak_reserved_bytes"] / 2 ** 30
