"""A/B of the port's kernels and paths between checkouts, on one card.

    python3 tools/kernel_ab.py [--phases P1,P2,...] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout of this repository (for example
the parent commit unpacked with ``git archive`` into a git-ignored
directory, and ``.``).  They run in the order given, one process each, so
each imports its own ``repro_torch`` and builds its own kernels; list them
as parent, change, change, parent to see the spread.  Each process runs
that checkout's own ``chip_smoke.py`` phases, with the geometries of this
repository's ``chip_smoke.py`` (the one above ``tools/``) in place of the
checkout's (``GEOMETRIES``, ``CS_GEOMETRIES``, ``UNSKETCH_GEOMETRIES``,
``SKETCH_GEOMETRIES``), so a parent with fewer geometries runs the same
ones.  A sketch_update geometry of several pieces (a sixth field) that
the checkout's own phase does not take is timed here instead, through
the checkout's ``sketch_update`` wrapper in the estimates form, as the
newer phase times it.  ``--phases`` picks them, in this order (default
``kernel,kv,model,sketch_model,serve,long``): ``kernel`` (paged
attention), ``sketch`` (sketch_update), ``kv`` (tail_fold, tail_scores,
and the sharded forms where the checkout has them),
``cs`` (count_sketch, unsketch), ``cpd`` (the paper core and CPD at the
paper's sizes), ``model`` and ``sketch_model`` (the full-width gemma-2b
decode steps at max_seq 512 and, sketched, at 8192, with their
profiles), ``serve`` (the 16-request stream; runs ``model`` first for its
logit gap), ``spec`` (the speculative engines on that stream), ``long``
(the 8k stream), ``long_spec`` (the sketched speculative run),
``train`` (4 steps of
full-width yi-9b with sketched AdamW, one profiled; in a checkout whose
phase has its 4096-token steps, those too, with the dry-run process they
read) and ``train_families`` (phase train-families: every family's
sketched-AdamW steps, one profiled) and ``ranks`` (phase launch's
emulated ranks, which need no process group: one FSDP rank's strided
sketch_update pieces timed, the kv_blocks ranks' sharded two-span
attention and fold, the EP ranks' MoE layer; each where the checkout
has it, with the card's clocks after).  Every line a phase
prints is passed through, prefixed by the checkout.  Exits non-zero if
any run fails.  A checkout whose ``chip_smoke.py`` has no ``spec`` or
``long_spec`` phase says so and skips it.

    python3 tools/kernel_ab.py --phases sketch,kv,train \
        build/parent . . build/parent
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("kernel", "sketch", "kv", "cs", "cpd", "model", "sketch_model",
          "serve", "spec", "long", "long_spec", "train", "train_families",
          "ranks")
DEFAULT = "kernel,kv,model,sketch_model,serve,long"
SHARED = ("GEOMETRIES", "CS_GEOMETRIES", "UNSKETCH_GEOMETRIES",
          "SKETCH_GEOMETRIES")


def load_smoke(root: str):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def sketch_leaf(cs, name, geo, flush) -> None:
    """Device ms of the checkout's sketch_update (estimates form, each
    piece's estimates dropped as they come) on a geometry of several
    pieces, for a checkout whose phase takes one piece a geometry."""
    import torch
    from repro_torch.kernels.sketch_update import sketch_update
    from repro_torch.sketch.hashing import cached_coeffs
    n, C, R, off, dt, npieces = geo
    dev = flush.device
    gen = torch.Generator(dev).manual_seed(cs.SEED)
    pieces = [(torch.randn(n, generator=gen, device=dev).to(dt),
               off + k * n) for k in range(npieces)]
    m = torch.randn((R, C), generator=gen, device=dev)
    v = torch.randn((R, C), generator=gen, device=dev).abs_()
    cm = cached_coeffs(n + 3, R, device=dev)
    cv = cached_coeffs(n + 4, R, device=dev)
    ms, parts, _ = cs.device_ms(
        lambda: [None for _ in sketch_update(pieces, m, v, cm, cv, b1=0.9,
                                             b2=0.95)], 2, flush)
    print(f"[kernel] sketch_update {name} (n={n} x {npieces} pieces, C={C}, "
          f"R={R}, offset={off}, g {str(dt)[6:]}; timed by kernel_ab): "
          f"estimates form kernel_ms={ms:.5f} ("
          + ", ".join(f"{k[:40]} {v:.5f}" for k, v in parts.items()) + ")")
    del pieces, m, v
    torch.cuda.empty_cache()


def run_one(checkout: str, phases) -> None:
    root = os.path.abspath(checkout)
    sys.path.insert(0, os.path.join(root, "src"))
    cs = load_smoke(root)
    if hasattr(cs, "load_rates"):     # the rates from launch/cost_analysis
        cs.load_rates()
    home = load_smoke(HOME)
    takes_pieces = any(len(g) > 5 for g in cs.SKETCH_GEOMETRIES.values())
    for name in SHARED:
        setattr(cs, name, dict(getattr(home, name)))
    leaves = {k: g for k, g in cs.SKETCH_GEOMETRIES.items()
              if len(g) > 5 and not takes_pieces}
    cs.SKETCH_GEOMETRIES = {k: g for k, g in cs.SKETCH_GEOMETRIES.items()
                            if k not in leaves}

    import torch
    from repro_torch.kernels import build
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
    if "sketch" in phases:
        cs.phase_sketch_kernel(flush)
        for name, geo in leaves.items():
            sketch_leaf(cs, name, geo, flush)
    if "kv" in phases:
        cs.phase_kv_kernels(flush)
        if hasattr(cs, "phase_kv_forms"):
            cs.phase_kv_forms(flush)
    if "cs" in phases:
        cs.phase_cs_kernels(flush)
    if "cpd" in phases:
        cs.phase_cpd(dev)
    if {"model", "sketch_model", "serve", "spec", "long",
            "long_spec"} & set(phases):
        serve_phases(cs, phases, dev, flush)
    del flush
    import gc
    for name, fn in (("train", cs.phase_train),
                     ("train_families", cs.phase_train_families)):
        if name in phases:
            gc.collect()
            torch.cuda.empty_cache()
            fn(dev)
    if "ranks" in phases:
        for fn in ("launch_emulated_ranks", "launch_emulated_kv",
                   "launch_emulated_ep"):
            if hasattr(cs, fn):
                getattr(cs, fn)(dev)
                clocks = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
                     "temperature.gpu,power.draw", "--format=csv,noheader"],
                    capture_output=True, text=True).stdout.strip()
                print(f"[ab] after {fn}: sm, mem clocks, temperature, "
                      f"power: {clocks}", flush=True)
            else:
                print(f"[ab] this checkout has no {fn}")


def serve_phases(cs, phases, dev, flush) -> None:
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config("gemma-2b")
    params = tf.init_params(cfg, seed=cs.SEED, device=dev)
    gap = None
    if "model" in phases or "serve" in phases:
        gap = cs.phase_model(cfg, params, dev, flush)
    if "sketch_model" in phases:
        cs.phase_sketch_model(cfg, params, dev, flush)
    if "serve" in phases:
        cs.phase_serve(cfg, params, dev, gap)
    for name, fn in (("spec", "phase_spec"), ("long", "phase_long_serve"),
                     ("long_spec", "phase_long_spec")):
        if name not in phases:
            continue
        if not hasattr(cs, fn):
            print(f"[ab] this checkout has no {name} phase")
            continue
        getattr(cs, fn)(cfg, params, dev)


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
