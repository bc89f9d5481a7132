#!/usr/bin/env python3
"""Audit one training step of each config for float sums whose order the
card does not fix.

For each config at full width, cut in depth (``DEPTH``; ``--reduced``:
the reduced configs), one batch of 8 x 128 tokens (``--batch``,
``--seq``):

  1. the gradient step (forward and backward) under
     ``train/determinism.py:OrderAudit``: the operations it flags (float
     adds into shared targets, device-wide float scans, operations with
     no deterministic CUDA path);
  2. the same step under ``torch.use_deterministic_algorithms(True,
     warn_only=True)`` (``CUBLAS_WORKSPACE_CONFIG=:4096:8`` is set before
     torch starts cuBLAS): every warning PyTorch raises for an operation
     it knows no deterministic path for; the caller's setting is restored
     after the step;
  3. the step twice in the default mode: the loss and every gradient
     piece compared bitwise;
  4. sketched AdamW (ratio 4, rows 3) from those gradients, twice from
     equal states: every param and moment table compared bitwise.

Prints one line a config and writes the lines as JSON to ``--out``.

    python3 tools/determinism_audit.py [--archs a,b] [--out f.json]
    PYTHONPATH=src python tools/determinism_audit.py --device cpu --reduced
"""
import argparse
import dataclasses
import json
import os
import sys
import time
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          reduced_config)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.sketch.optimizer import (sketched_adamw_init,  # noqa: E402
                                          sketched_adamw_update)
from repro_torch.train import data as data_lib  # noqa: E402
from repro_torch.train.determinism import OrderAudit  # noqa: E402

# layers kept at full width: two of every layer kind (one xLSTM group of
# 7 mLSTM + 1 sLSTM; two zamba2 groups of 6 Mamba-2 layers and a shared
# attention block)
DEPTH = {"xlstm-1.3b": 8, "zamba2-2.7b": 12}


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def pieces(tree):
    return [t for _, ps in tf.param_leaves(tree) for t in ps]


def audit(arch, args, dev):
    t0 = time.perf_counter()
    if args.reduced:
        cfg = reduced_config(arch)
    else:
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=DEPTH.get(arch, 2))
    params = tf.init_params(cfg, seed=0, device=dev)
    batch = data_lib.make_batch(cfg, 0, args.batch, args.seq, 0, dev)
    step = M.make_train_step(cfg)
    with OrderAudit() as order:
        step(params, batch)
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(params, batch)
        finally:
            torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    warned = sorted({str(w.message).split(" does not have")[0]
                     for w in caught
                     if "deterministic" in str(w.message)})
    loss_a, grads_a = step(params, batch)
    loss_b, grads_b = step(params, batch)
    ga, gb = pieces(grads_a), pieces(grads_b)
    grad_bits = sum(torch.equal(bits(x), bits(y)) for x, y in zip(ga, gb))
    del grads_b, gb
    states = []
    for _ in range(2):
        p = tf.tree_map(torch.clone, params)
        st = sketched_adamw_init(p, 4, 3, 1 << 16 if not args.reduced
                                 else 4096)
        sketched_adamw_update(grads_a, st, p, lr=3e-4)
        states.append((p, st))
    (pa, sa), (pb, sb) = states
    param_bits = sum(torch.equal(bits(x), bits(y))
                     for x, y in zip(pieces(pa), pieces(pb)))
    tables, table_bits = 0, 0
    for a, b in zip(sa.moments, sb.moments):
        if hasattr(a.m, "table"):
            for x, y in ((a.m.table, b.m.table), (a.v.table, b.v.table)):
                tables += 1
                table_bits += torch.equal(x, y)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = dict(arch=arch, layers=cfg.num_layers, flagged=order.summary(),
               warned=warned, loss_bits=bool(torch.equal(loss_a, loss_b)),
               grad_pieces=len(ga), grad_bits=int(grad_bits),
               param_pieces=len(pieces(pa)), param_bits=int(param_bits),
               tables=tables, table_bits=int(table_bits),
               scatter_adds=order.counts["scatter_add"],
               index_puts=order.counts["index_put"]
               + order.counts["index_put_"],
               seconds=round(time.perf_counter() - t0, 1))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(ARCH_IDS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for arch in args.archs.split(","):
        row = audit(arch, args, dev)
        rows.append(row)
        ok = (not row["flagged"] and row["loss_bits"]
              and row["grad_bits"] == row["grad_pieces"]
              and row["param_bits"] == row["param_pieces"]
              and row["table_bits"] == row["tables"])
        print(f"[audit] {'ok' if ok else 'VARIES'} {json.dumps(row)}",
              flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(f"[audit] {torch.cuda.get_device_name(0)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
