"""Small versions of the cells, for the CPU tests: the same files with
the widths, depths and traffic cut down so that a run takes seconds.

Their limits are the small size's own, set as the cells' are (between
sound runs' readings and the control's, on the CPU): at 64 wide the
program's bfloat16 weights round its steps and logits more than at the
published widths."""
from perfbench import common

# readings on the CPU, seeds 1, 31337, 2^31 + 9 (train) and 7, 99,
# 2^31 + 9, 5, 6, 1234567890123 (serve): grad_gap sound 0.0021-0.0067, control 0.041-0.084;
# moment_gap sound 0.025-0.026, control 0.35-0.54, a wrong hash seed
# 2.1-2.2; delta_gap sound 0.015-0.020, state unchanged about 1;
# request_logit_gap sound 0.0-0.0003, control 0.079-0.27;
# worst_token_rank (of 500 tokens) sound 0-56 over 12 runs (at 64 wide
# the logits lie close), control 29-419, a token altered 397-495
LIMITS = {"yi-9b.train-4k-sketched": {"grad_gap": 0.02, "moment_gap": 0.1,
                                      "delta_gap": 0.3},
          "granite-moe-3b.serve-chat": {"request_logit_gap": 0.03,
                                        "worst_token_rank": 250.0,
                                        "short_answers": 0.0}}


def train_cell():
    conf = common.load_json(common.HERE / "configs" / "yi-9b.json")
    conf.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=160,
                vocab_size=500)
    mix = common.load_mix("train-4k-sketched")
    mix.update(seq=32)
    mix["optimizer"]["opt_state_min_elems"] = 256
    return "yi-9b.train-4k-sketched", conf, mix


def serve_cell():
    conf = common.load_json(
        common.HERE / "configs" / "granite-moe-3b-a800m.json")
    conf.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=32,
                vocab_size=500, num_local_experts=8, num_experts_per_tok=2,
                attention_multiplier=0.25)
    mix = common.load_mix("serve-chat")
    mix.update(clients=4, requests=64, ramp_s=0.3)
    mix["shared_prefix"]["tokens"] = 32
    mix["prompt_tokens"].update(median=48, min=36, max=72)
    mix["max_new"].update(median=10, min=4, max=24)
    mix["engine"].update(max_batch=4, max_seq=128, prefill_bucket=16,
                         decode_chunk=4, prefix_cache_bytes=1 << 20)
    return "granite-moe-3b.serve-chat", conf, mix


def run(cell, seed=1234567890123, seconds=None, trace=False, **kw):
    """One run of a small cell; the serving window (3 s) lets the CPU's
    eager decode complete a dozen requests or more."""
    from perfbench import harness
    name, conf, mix = cell
    if seconds is None:
        seconds = 3.0 if mix["kind"] == "serve" else 1.0
    kw.setdefault("limits", LIMITS[name])
    return harness.run_cell(name, seed, seconds, trace, device="cpu",
                            conf=conf, mix=mix, log=lambda s: None, **kw)
