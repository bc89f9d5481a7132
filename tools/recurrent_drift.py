"""How far the recurrent families' two forms, and bf16 itself, move the
logits, on one card.

    python3 tools/recurrent_drift.py [--arch xlstm-1.3b,zamba2-2.7b]
        [--lens 0,7,63,447] [--steps 32]
        [--out chiprun_out/recurrent_drift.json]

Builds each config at full width and depth (random weights from
``chip_smoke.py``'s seed) and, for each prompt length S, a batch of four
sequences of S + ``--steps`` tokens.  It runs two paths over them
(``chip_smoke.py:decode_vs_forward``):

  forward      the full-sequence (training) forward over all the tokens
  decode       ``prefill`` of the first S tokens (S = 0: a zero state),
               then one teacher-forced ``decode_step`` per later token,
               the served form

each in bf16 (the served weights) and in f32 (the same weights read as
f32, f32 activations and slot state).  It prints, as % of the f32
forward's max|logit|, over the first token and over all ``--steps``:
decode vs forward in bf16 (the first token is what ``chip_smoke.py``'s
decode check holds, all of them what its recompute oracle meets over a
served request) and in f32 (the two forms' own gap, rounding aside), and
each bf16 path against its f32 twin.
Writes every number to ``--out`` as JSON.  ``--device cpu --reduced``
runs the reduced configs on the CPU to try the script.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HOME, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm-1.3b,zamba2-2.7b")
    ap.add_argument("--lens", default="0,7,63,447")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--out", default=os.path.join(HOME, "chiprun_out",
                                                  "recurrent_drift.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HOME, "src"))
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf
    cs = load_smoke()
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card() if dev.type == "cuda" else "the CPU"
    out = {"card": card, "archs": {}}

    for arch in args.arch.split(","):
        t0 = time.perf_counter()
        cfg = reduced_config(arch) if args.reduced else get_config(arch)
        params = tf.init_params(cfg, seed=cs.SEED, device=dev)
        p32 = tf.tree_map(lambda t: t.float(), params)
        rng = np.random.RandomState(cs.SEED + 31)
        rows = {}
        T = args.steps
        for S in (int(s) for s in args.lens.split(",")):
            seq = torch.as_tensor(rng.randint(0, cfg.vocab_size, (4, S + T)),
                                  device=dev)
            f16, d16 = cs.decode_vs_forward(params, cfg, seq, S,
                                            torch.bfloat16)
            f32, d32 = cs.decode_vs_forward(p32, cfg, seq, S, torch.float32)

            def pct(a, b, steps):
                """max over the first ``steps`` tokens, % of max|logit|"""
                return 100 * (a[:, :steps] - b[:, :steps]).abs().max().item() \
                    / f32[:, :steps].abs().max().item()

            rows[S] = {f"{what}_{k}": pct(a, b, k) for k in (1, T)
                       for what, a, b in (
                           ("decode_vs_forward_bf16", d16, f16),
                           ("decode_vs_forward_f32", d32, f32),
                           ("forward_bf16_vs_f32", f16, f32),
                           ("decode_bf16_vs_f32", d16, d32))}
            r = rows[S]
            print(f"[drift] {arch} S {S}, % of max|logit|, first token / "
                  f"all {T}: decode vs forward bf16 "
                  f"{r['decode_vs_forward_bf16_1']:.3f} / "
                  f"{r[f'decode_vs_forward_bf16_{T}']:.3f}, f32 "
                  f"{r['decode_vs_forward_f32_1']:.5f} / "
                  f"{r[f'decode_vs_forward_f32_{T}']:.5f}; bf16 vs f32: "
                  f"forward {r['forward_bf16_vs_f32_1']:.3f} / "
                  f"{r[f'forward_bf16_vs_f32_{T}']:.3f}, decode "
                  f"{r['decode_bf16_vs_f32_1']:.3f} / "
                  f"{r[f'decode_bf16_vs_f32_{T}']:.3f}; {card}", flush=True)
        out["archs"][arch] = rows
        print(f"[drift] {arch}: {time.perf_counter() - t0:.1f}s")
        del params, p32
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
