"""serve.mfu: forward FLOPs of the tokens the window prefilled and
decoded (2 x active matmul params + attention over each token's context,
``roofline.forward_token_flops``) over the window times the card's bf16
peak, in %."""
from perfbench import roofline


def read(obs):
    if obs.get("kind") != "serve":
        return None
    conf = obs["conf"]
    flops = sum(roofline.forward_token_flops(conf, c)
                for c in obs["decode_ctx_window"])
    for r, hit in obs["prefilled"]:
        start = r.shared_len if hit else 0
        n = len(r.prompt) - 1 - start
        if n > 0:
            mean_ctx = (start + len(r.prompt)) / 2.0
            flops += n * roofline.forward_token_flops(conf, mean_ctx)
    return 100.0 * flops / (obs["window_s"] * roofline.BF16_FLOPS)
