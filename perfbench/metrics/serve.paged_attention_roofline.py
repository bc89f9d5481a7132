"""serve.paged_attention_roofline: the least time of the KV bytes that
the profiled stretch's attention needs, at the card's bandwidth, over the
paged-attention kernels' device time there, in %.  Bytes: every decoded
token's context rows read once per layer (tokens of decode chunks that
started inside the stretch), and for each prompt prefilled wholly inside
it, each 256-row chunk's context rows read once per layer (a shared
prompt the prefix cache served is not prefilled)."""
from perfbench import roofline


def read(obs):
    p = obs.get("profile")
    if obs.get("kind") != "serve" or p is None:
        return None
    t = p.seconds_matching("paged_attention")
    if t <= 0:
        return None
    conf = obs["conf"]
    bucket = obs["mix"]["engine"]["prefill_bucket"]
    rows = sum(obs["decoded_ctx"])
    for r, hit in obs["profiled_prefills"]:
        start = r.shared_len if hit else 0
        rows += sum(min(o + bucket, len(r.prompt))
                    for o in range(start, len(r.prompt), bucket))
    least = roofline.least_ms(rows * roofline.kv_row_bytes(conf)) / 1e3
    return 100.0 * least / t
