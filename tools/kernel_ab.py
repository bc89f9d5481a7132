"""A/B of the port's kernels and paths between checkouts, on one card.

    python3 tools/kernel_ab.py [--phases P1,P2,...] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout of this repository (for example
the parent commit unpacked with ``git archive`` into a git-ignored
directory, and ``.``).  They run in the order given, one process each, so
each imports its own ``repro_torch`` and builds its own kernels; list them
as parent, change, change, parent to see the spread.  Each process runs
that checkout's own ``chip_smoke.py`` phases, with the geometries of this
repository's ``chip_smoke.py`` (the one above ``tools/``) in place of the
checkout's (``GEOMETRIES``, ``CS_GEOMETRIES``, ``UNSKETCH_GEOMETRIES``), so
a parent with fewer geometries runs the same ones.  ``--phases`` picks
them, in this order (default ``kernel,kv,model,sketch_model,serve,long``):
``kernel`` (paged attention), ``kv`` (tail_fold, tail_scores), ``cs``
(count_sketch, unsketch), ``cpd`` (the paper core and CPD at the paper's
sizes), ``model`` and ``sketch_model`` (the full-width gemma-2b decode
steps at max_seq 512 and, sketched, at 8192, with their profiles),
``serve`` (the 16-request stream; runs ``model`` first for its logit
gap) and ``long`` (the 8k stream).  Every line a phase prints is passed
through, prefixed by the checkout.  Exits non-zero if any run fails.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("kernel", "kv", "cs", "cpd", "model", "sketch_model", "serve",
          "long")
DEFAULT = "kernel,kv,model,sketch_model,serve,long"
SHARED = ("GEOMETRIES", "CS_GEOMETRIES", "UNSKETCH_GEOMETRIES")


def load_smoke(root: str):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def run_one(checkout: str, phases) -> None:
    root = os.path.abspath(checkout)
    sys.path.insert(0, os.path.join(root, "src"))
    cs = load_smoke(root)
    home = load_smoke(HOME)
    for name in SHARED:
        setattr(cs, name, dict(getattr(home, name)))

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
    print(f"[ab] {cs.card()}; phases {','.join(phases)}")
    flush = torch.zeros(64 << 20, dtype=torch.int32, device=dev)
    if "kernel" in phases:
        cs.phase_kernel(flush)
    if "kv" in phases:
        cs.phase_kv_kernels(flush)
    if "cs" in phases:
        cs.phase_cs_kernels(flush)
    if "cpd" in phases:
        cs.phase_cpd(dev)
    if not {"model", "sketch_model", "serve", "long"} & set(phases):
        return
    cfg = get_config("gemma-2b")
    params = tf.init_params(cfg, seed=cs.SEED, device=dev)
    gap = None
    if "model" in phases or "serve" in phases:
        gap = cs.phase_model(cfg, params, dev, flush)
    if "sketch_model" in phases:
        cs.phase_sketch_model(cfg, params, dev, flush)
    del flush
    if "serve" in phases:
        cs.phase_serve(cfg, params, dev, gap)
    if "long" in phases:
        cs.phase_long_serve(cfg, params, dev)


def parse(argv):
    phases = DEFAULT
    if argv[:1] == ["--phases"] and len(argv) > 1:
        phases, argv = argv[1], argv[2:]
    picked = tuple(p for p in PHASES if p in phases.split(","))
    unknown = set(phases.split(",")) - set(PHASES)
    if unknown or not picked:
        sys.exit(f"unknown or no phases {sorted(unknown)}; choose from "
                 f"{','.join(PHASES)}")
    return picked, argv


def main() -> None:
    phases, args = parse(sys.argv[1:])
    if len(args) == 2 and args[0] == "--one":
        run_one(args[1], phases)
        return
    if not args:
        sys.exit(__doc__)
    rc = 0
    for checkout in args:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--phases", ",".join(phases), "--one",
                               checkout], capture_output=True, text=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            print(f"{checkout}: {line}", flush=True)
        print(f"{checkout}: exit {proc.returncode}", flush=True)
        rc = rc or proc.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
