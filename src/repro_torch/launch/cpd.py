"""FCS-accelerated CP decomposition (the paper's flagship application):
decompose a noisy symmetric low-rank tensor with plain and sketched RTPM
and print each method's residuals and time.  The port's counterpart of
``examples/cpd_sketched.py``.

    PYTHONPATH=src python -m repro_torch.launch.cpd [--device cpu] \\
        [--paper-size] [--methods plain,ts,fcs,cs]

The default is the example's setting (I = 50, rank 8, sigma 0.01, J = 800,
D = 10, 12 inits of 15 iterations); ``--paper-size`` is the paper's Fig. 1
(I = 100, rank 10, D = 2, 15 inits of 20 iterations, TS and FCS at
J in {1000, 4000, 10000}, CS on vec(T) at J = 10000).  The tensor, the
hashes and the inits are drawn from one CPU ``torch.Generator`` seeded 0.
Runs on the card unless ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.core.hashes import storage_bytes_cs_long
from repro_torch.cpd.rtpm import cp_reconstruct, rtpm_decompose, rtpm_hashes
from repro_torch.device import DeviceLike, resolve_device

EXAMPLE = dict(I=50, R=8, sigma=0.01, D=10, L=12, T=15,
               runs=(("plain", 0), ("ts", 800), ("fcs", 800)))
# paper Fig. 1 (benchmarks/bench_rtpm.py --paper-size)
FIG1 = dict(I=100, R=10, sigma=0.01, D=2, L=15, T=20,
            runs=(("plain", 0),) + tuple((m, J) for m in ("ts", "fcs")
                                         for J in (1000, 4000, 10000))
            + (("cs", 10000),))


def symmetric_tensor(I: int, R: int, sigma: float,
                     generator: torch.Generator, device: DeviceLike = None):
    """(noisy T, clean T): rank R with orthonormal factors and unit
    weights, plus sigma-scaled Gaussian noise, f32 on ``device``."""
    Q, _ = torch.linalg.qr(torch.randn((I, I), generator=generator))
    U = Q[:, :R]
    Tc = torch.einsum("ar,br,cr->abc", U, U, U)
    Tn = Tc + sigma * torch.randn((I, I, I), generator=generator)
    dev = resolve_device(device)
    return Tn.to(dev), Tc.to(dev)


def residuals(Tn: torch.Tensor, Tc: torch.Tensor, lams: torch.Tensor,
              U: torch.Tensor):
    """Relative residuals against the observed and the clean tensor."""
    R = cp_reconstruct(lams, U)
    return (float(torch.linalg.vector_norm(Tn - R)
                  / torch.linalg.vector_norm(Tn)),
            float(torch.linalg.vector_norm(Tc - R)
                  / torch.linalg.vector_norm(Tc)))


def hash_bytes(method: str, I: int, J: int, D: int) -> int:
    """Tabulated hash memory of a method: three (D, I) pairs for the
    per-mode sketches, one (D, I^3) pair for CS on vec(T)."""
    if method == "plain":
        return 0
    if method == "cs":
        return storage_bytes_cs_long((I, I, I), D)
    return 3 * D * I * 8


def decompose(Tn: torch.Tensor, R: int, method: str, J: int, D: int, L: int,
              T: int, generator: torch.Generator,
              use_kernel: Optional[bool] = None, hashes=None, inits=None):
    """RTPM of Tn by ``method`` with hashes and inits drawn from
    ``generator`` unless given; returns (lams, U, seconds), the time
    ending in a device synchronize."""
    I = Tn.shape[0]
    if hashes is None:
        hashes = rtpm_hashes(I, method, J, D, generator, Tn.device)
    if inits is None:
        inits = torch.randn((R, L, I), generator=generator)
    if Tn.device.type == "cuda":
        torch.cuda.synchronize(Tn.device)
    t0 = time.perf_counter()
    lams, U = rtpm_decompose(Tn, R, method=method, n_inits=L, n_iters=T,
                             hashes=hashes, inits=inits,
                             use_kernel=use_kernel)
    if Tn.device.type == "cuda":
        torch.cuda.synchronize(Tn.device)
    return lams, U, time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--paper-size", action="store_true",
                    help="the paper's Fig. 1 setting (I = 100, D = 2)")
    ap.add_argument("--methods", default=None,
                    help="comma-separated subset of the setting's methods "
                         "(plain,ts,fcs; cs with --paper-size)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = FIG1 if args.paper_size else EXAMPLE
    runs = cfg["runs"]
    if args.methods:
        runs = tuple(r for r in runs if r[0] in args.methods.split(","))
    gen = torch.Generator().manual_seed(0)
    I, R = cfg["I"], cfg["R"]
    Tn, Tc = symmetric_tensor(I, R, cfg["sigma"], gen, dev)
    print(f"symmetric CP rank-{R} tensor, {I}^3, sigma={cfg['sigma']}, "
          f"D={cfg['D']}, {cfg['L']} inits x {cfg['T']} iterations, on "
          f"{dev}")
    for method, J in runs:
        lams, U, sec = decompose(Tn, R, method, J, cfg["D"], cfg["L"],
                                 cfg["T"], gen)
        r_obs, r_clean = residuals(Tn, Tc, lams, U)
        print(f"  {method:6s} J={J:5d}: residual {r_obs:.4f} (observed), "
              f"{r_clean:.4f} (clean); hash bytes "
              f"{hash_bytes(method, I, J, cfg['D'])}; {sec:.2f}s")
    print("expected ordering: plain < fcs <= ts (Prop. 1)")


if __name__ == "__main__":
    main()
