"""CP-ALS (Kolda & Bader 2009), plain and sketched, paper Section 4.1.2
(the port of ``repro/cpd/als.py``).

Each sweep solves, for each mode, the least-squares problem against the
Khatri-Rao product of the other factors.  The MTTKRP columns are the
contractions of Eq. 18, T(I, b_r, c_r) etc., so the sketched variants
estimate them with the Eq. 17 trick: all R columns of the two other
factors are count-sketched in one kernel call each, and every column's
estimate is read in one unsketch call.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import (
    ModeHash, cs_apply_batch, fcs_general, make_tensor_hashes,
    median_combine, ts_general,
)
from repro_torch.core.contraction import correlate
from repro_torch.kernels.ops import unsketch_op

Factors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _solve(mttkrp: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """mttkrp (I, R) @ pinv(G) with G = (B^T B) * (C^T C)."""
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    return torch.linalg.solve(G + 1e-6 * eye, mttkrp.T).T


def _mttkrp_plain(T: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  mode: int) -> torch.Tensor:
    sub = {0: "abc,br,cr->ar", 1: "abc,ar,cr->br", 2: "abc,ar,br->cr"}
    return torch.einsum(sub[mode], T, B, C)


def _mttkrp_sketched(sk: torch.Tensor, hashes: Sequence[ModeHash],
                     B: torch.Tensor, C: torch.Tensor, mode: int,
                     circular: bool,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Columns r: the T(I, b_r, c_r)-style contraction for the free mode.
    sk is the (D, J~) FCS (or (D, J) TS) sketch of T.  -> (I_free, R)."""
    order = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}[mode]
    mh_free = hashes[order[0]]
    mh_b, mh_c = hashes[order[1]], hashes[order[2]]
    n = sk.shape[-1]
    z = correlate(sk, cs_apply_batch(B.T, mh_b, use_kernel),
                  cs_apply_batch(C.T, mh_c, use_kernel), n)   # (D, R, n)
    h = mh_free.h % n if circular else mh_free.h
    est = unsketch_op(z.contiguous(), h, mh_free.s, use_kernel)
    return median_combine(est).T


def als_sweep(mttkrp, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """One sweep over the three modes; returns (A, B, C, lam) with unit
    columns in A, B, C."""
    G = (B.T @ B) * (C.T @ C)
    A = _solve(mttkrp(B, C, 0), G)
    A = A / (torch.linalg.vector_norm(A, dim=0) + 1e-12)
    G = (A.T @ A) * (C.T @ C)
    B = _solve(mttkrp(A, C, 1), G)
    B = B / (torch.linalg.vector_norm(B, dim=0) + 1e-12)
    G = (A.T @ A) * (B.T @ B)
    C = _solve(mttkrp(A, B, 2), G)
    # A, B are unit-norm when C is solved, so C's column norms carry
    # the full lambda.
    lam = torch.linalg.vector_norm(C, dim=0) + 1e-12
    return A, B, C / lam, lam


def als_inits(T: torch.Tensor, rank: int, generator: torch.Generator,
              n_inits: int = 3) -> List[Factors]:
    """HOSVD (plus 0.01 noise) and n_inits - 1 random inits, drawn from
    ``generator`` (CPU) and moved to T's device."""
    def draw(*shape):
        return torch.randn(shape, generator=generator).to(T.device)

    def hosvd(mode):
        dim = T.shape[mode]
        M = torch.movedim(T, mode, 0).reshape(dim, -1)
        base = torch.linalg.svd(M, full_matrices=False)[0][:, :rank]
        if base.shape[1] < rank:
            base = torch.nn.functional.pad(base, (0, rank - base.shape[1]))
        return base + 0.01 * draw(dim, rank)

    inits = [(hosvd(0), hosvd(1), hosvd(2))]
    for _ in range(max(n_inits - 1, 0)):
        inits.append(tuple(draw(dim, rank) for dim in T.shape))
    return inits


def als_decompose(T: torch.Tensor, rank: int,
                  generator: Optional[torch.Generator] = None,
                  method: str = "plain", hash_len: int = 3000,
                  n_sketches: int = 10, n_iters: int = 20, n_inits: int = 3,
                  inits: Optional[Sequence[Factors]] = None,
                  hashes: Optional[Sequence[ModeHash]] = None,
                  use_kernel: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, list]:
    """Asymmetric CP decomposition T ~= [[lam; A, B, C]].  Returns
    (lam (R,), [A, B, C]).

    Every init (default ``als_inits``: HOSVD, whose leading singular
    vectors are an arbitrary rotation of the factors when the unfolding
    spectrum is degenerate, plus random ones that break the symmetry) is
    probed for a few sweeps; the best by residual continues.  ``inits``
    and ``hashes`` replace the drawn ones."""
    if inits is None:
        inits = als_inits(T, rank, generator, n_inits)
    if method != "plain" and hashes is None:
        hashes = make_tensor_hashes(T.shape, hash_len, n_sketches, generator,
                                    T.device)
    return als_fit(T, rank, make_mttkrp(T, method, hashes, use_kernel),
                   inits, n_iters)


def make_mttkrp(T: torch.Tensor, method: str,
                hashes: Optional[Sequence[ModeHash]] = None,
                use_kernel: Optional[bool] = None):
    """The method's ``mttkrp(B, C, mode)`` over T: exact for ``plain``,
    else through the FCS / TS sketch of T under ``hashes``."""
    if method == "plain":
        return lambda Bm, Cm, mode: _mttkrp_plain(T, Bm, Cm, mode)
    sk = (fcs_general if method == "fcs" else ts_general)(T, hashes)
    return lambda Bm, Cm, mode: _mttkrp_sketched(
        sk, hashes, Bm, Cm, mode, method == "ts", use_kernel)


def als_fit(T: torch.Tensor, rank: int, mttkrp, inits: Sequence[Factors],
            n_iters: int) -> Tuple[torch.Tensor, list]:
    """``als_decompose``'s iteration for a given ``mttkrp(B, C, mode)``:
    probe every init for a few sweeps, continue the best by residual
    against T."""
    probe_iters = min(max(2, n_iters // 4), n_iters)
    best, best_res = None, math.inf
    for A, B, C in inits:
        lam = torch.ones(rank, dtype=T.dtype, device=T.device)
        for _ in range(probe_iters):
            A, B, C, lam = als_sweep(mttkrp, A, B, C)
        res = float(als_residual(T, lam, [A, B, C]))
        # a divergent probe (NaN residual) neither wins nor shadows a
        # later finite candidate
        if best is None or res < best_res or (math.isnan(best_res)
                                              and not math.isnan(res)):
            best, best_res = (A, B, C, lam), res
    A, B, C, lam = best
    for _ in range(n_iters - probe_iters):
        A, B, C, lam = als_sweep(mttkrp, A, B, C)
    return lam, [A, B, C]


def als_residual(T: torch.Tensor, lam: torch.Tensor,
                 factors: list) -> torch.Tensor:
    A, B, C = factors
    R = torch.einsum("r,ar,br,cr->abc", lam, A, B, C)
    return torch.linalg.vector_norm(T - R) / torch.linalg.vector_norm(T)
