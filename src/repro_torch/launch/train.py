"""Training driver of the port, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \
      --steps 100 --batch 8 --seq 128 [--full] [--opt-state-ratio 4] \
      [--ckpt-dir /tmp/run1 --resume] [--device cpu]

The flags are the reference's (``repro/launch/train.py``) plus
``--device``.  The reduced config is the default and ``--full`` trains
the published widths; weights are random, from a seeded
``torch.Generator``.  ``--grad-compression`` is accepted and raises
until FCS gradient compression is ported.  Without a card and without
``--device cpu`` the driver raises.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.train.loop import train


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-9b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--opt-state-ratio", type=int, default=0,
                    help="> 0: sketch AdamW (m, v) moments at this "
                         "compression ratio (repro_torch.sketch)")
    ap.add_argument("--opt-state-min-elems", type=int, default=None,
                    help="leaves smaller than this keep dense moments "
                         "(default: config value; lower it for reduced "
                         "configs, whose leaves are all < 64Ki)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--crash-at-step", type=int, default=None,
                    help="failure injection for FT tests")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.opt_state_ratio:
        changes = {"opt_state_ratio": args.opt_state_ratio}
        if args.opt_state_min_elems is not None:
            changes["opt_state_min_elems"] = args.opt_state_min_elems
        cfg = dataclasses.replace(
            cfg, sketch=dataclasses.replace(cfg.sketch, **changes))
    hist = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, seed=args.seed, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, resume=args.resume,
                 grad_compression=args.grad_compression or None,
                 crash_at_step=args.crash_at_step, device=args.device)
    print(f"FINAL loss={hist.losses[-1]:.4f} steps={len(hist.losses)} "
          f"stragglers={len(hist.stragglers)}")
    return hist


if __name__ == "__main__":
    main()
