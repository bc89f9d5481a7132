"""A/B of the port's kernels and decode steps between checkouts, on one
card.

    python3 tools/kernel_ab.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout of this repository (for example
the parent commit unpacked with ``git archive`` into a git-ignored
directory, and ``.``).  They run in the order given, one process each, so
each imports its own ``repro_torch`` and builds its own kernels; list them
as parent, change, change, parent to see the spread.  Each process runs
that checkout's own ``chip_smoke.py`` phases, with the paged-attention
geometries of this repository's ``chip_smoke.py`` (the one above
``tools/``) in place of the checkout's: ``kernel`` (paged attention),
``kv`` (tail_fold, tail_scores), ``model`` and
``sketch_model`` (the full-width gemma-2b decode steps at max_seq 512 and,
sketched, at 8192, with their profiles), ``serve`` and ``long`` (the
16-request and the 8k streams).  Every line a phase prints is passed
through, prefixed by the checkout.  Exits non-zero if any run fails.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke(root: str):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def run_one(checkout: str) -> None:
    root = os.path.abspath(checkout)
    sys.path.insert(0, os.path.join(root, "src"))
    cs = load_smoke(root)
    cs.GEOMETRIES = dict(load_smoke(HOME).GEOMETRIES)

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    build.build_all()
    print(f"[ab] {cs.card()}")
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    cs.phase_kernel(flush)
    cs.phase_kv_kernels(flush)
    cfg = get_config("gemma-2b")
    params = tf.init_params(cfg, seed=cs.SEED, device=dev)
    gap = cs.phase_model(cfg, params, dev, flush)
    cs.phase_sketch_model(cfg, params, dev, flush)
    del flush
    cs.phase_serve(cfg, params, dev, gap)
    cs.phase_long_serve(cfg, params, dev)


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    rc = 0
    for checkout in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", checkout], capture_output=True,
                              text=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            print(f"{checkout}: {line}", flush=True)
        print(f"{checkout}: exit {proc.returncode}", flush=True)
        rc = rc or proc.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
