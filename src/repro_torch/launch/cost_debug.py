"""Debug helper (``repro/launch/hlo_debug.py``): walk one dry-run cell and
attribute its bytes, flops or collective bytes to aten ops and to the
port's functions that issued them (the reference attributes HLO
instructions to jax-level op names).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.cost_debug yi-9b train_4k \\
      [--what bytes|flops|coll] [--top 25] [--multi-pod]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import run_cell

_KEY = {"bytes": "bytes", "hbm": "bytes", "flops": "flops", "coll": "coll"}


def compile_cell(arch: str, shape_name: str, multi_pod: bool = False,
                 **cut) -> dict:
    """The cell's dry-run record with its per-op and per-function tables
    (``run_cell(..., sites=True)``; ``cut``: its layers / batch / seq /
    mesh_shape)."""
    cell = run_cell(arch, shape_name, multi_pod, sites=True, **cut)
    if cell["status"] != "ok":
        raise RuntimeError(cell.get("error") or cell.get("reason"))
    return cell


def attribute(cell: dict, top: int = 25, what: str = "bytes") -> list:
    """Print and return the ``top`` aten ops and the ``top`` functions by
    ``what`` (bytes, flops or coll), largest first."""
    key = _KEY[what]
    unit, scale = ("GFLOP", 1e9) if key == "flops" else ("GiB", 2**30)
    rows = []
    for table in ("by_op", "by_site"):
        ranked = sorted(((v.get(key, 0.0), k) for k, v in cell[table].items()
                         if v.get(key, 0.0)), reverse=True)[:top]
        print(f"-- {table[3:]} by {what} --")
        for val, name in ranked:
            print(f"{val / scale:12.3f} {unit}  {name}")
            rows.append((table, name, val))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--what", default="bytes", choices=sorted(_KEY))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    attribute(compile_cell(args.arch, args.shape, args.multi_pod),
              top=args.top, what=args.what)
