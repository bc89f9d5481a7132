"""Robust Tensor Power Method (Anandkumar et al. 2014), plain and sketched
(the port of ``repro/cpd/rtpm.py``).

For each rank-1 component: run L random initializations for T power
iterations u <- T(I,u,u)/||T(I,u,u)||, keep the best by lambda = T(u,u,u),
polish it for another T iterations, deflate, repeat.  The sketched
variants replace the two contractions with their CS/TS/HCS/FCS estimators
(paper Section 4.1.1, Table 1).

Oracles here take one vector u (I,) or a batch (B, I) and return
T(I,u,u) as (I,) / (B, I) and T(u,u,u) as a scalar / (B,): ``rtpm``
iterates its L inits as one batch, each row the same function the
reference maps over.  Every CS apply and lookup goes through the
count-sketch and unsketch kernels on the card (``use_kernel`` passes
through to the ops).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core import (
    ModeHash, cs_apply, cs_apply_batch, fcs_general, fcs_tiuu, fcs_tuuu,
    hcs_general, make_mode_hash, make_tensor_hashes, median_combine,
    ts_general, ts_tiuu, ts_tuuu,
)
from repro_torch.kernels.ops import unsketch_op

Oracle = Tuple[Callable, Callable]

# ---------------------------------------------------------------------------
# Contraction oracles
# ---------------------------------------------------------------------------


def plain_oracle(T: torch.Tensor) -> Oracle:
    def tiuu(u):
        return torch.einsum("abc,...b,...c->...a", T, u, u)

    def tuuu(u):
        return torch.einsum("abc,...a,...b,...c->...", T, u, u, u)
    return tiuu, tuuu


def fcs_oracle(T: torch.Tensor, hashes: Sequence[ModeHash],
               use_kernel: Optional[bool] = None) -> Oracle:
    sk = fcs_general(T, hashes)

    def tiuu(u):
        return median_combine(fcs_tiuu(sk, u, hashes, use_kernel))

    def tuuu(u):
        return median_combine(fcs_tuuu(sk, u, hashes, use_kernel))
    return tiuu, tuuu


def ts_oracle(T: torch.Tensor, hashes: Sequence[ModeHash],
              use_kernel: Optional[bool] = None) -> Oracle:
    sk = ts_general(T, hashes)

    def tiuu(u):
        return median_combine(ts_tiuu(sk, u, hashes, use_kernel))

    def tuuu(u):
        return median_combine(ts_tuuu(sk, u, hashes, use_kernel))
    return tiuu, tuuu


def cs_oracle(T: torch.Tensor, hashes_long: ModeHash,
              use_kernel: Optional[bool] = None) -> Oracle:
    """Plain CS on vec(T) with a LONG hash pair over prod(dims) entries
    (the O(prod I_n) storage baseline the paper compares against).
    T(I,u,u)_i is estimated as <CS(T), CS(e_i o u o u)>: one count sketch
    of the (I, I^3) matrix whose row i is vec(e_i o u o u) per vector u,
    materialized as the reference materializes each row."""
    I = T.shape[0]
    sk = cs_apply(T.reshape(-1), hashes_long, use_kernel)      # (D, J)

    def estimate_inner(V):                                     # (B, I^3)
        skv = cs_apply_batch(V, hashes_long, use_kernel)       # (D, B, J)
        return median_combine((skv * sk[:, None, :]).sum(-1))  # (B,)

    def tiuu(u):
        rows = []
        ar = torch.arange(I, device=T.device)
        for v in u.reshape(-1, I):
            M = torch.zeros((I, I, I * I), dtype=T.dtype, device=T.device)
            M[ar, ar] = torch.outer(v, v).reshape(-1)
            rows.append(estimate_inner(M.reshape(I, -1)))
        out = torch.stack(rows)
        return out[0] if u.ndim == 1 else out

    def tuuu(u):
        V = torch.einsum("...a,...b,...c->...abc", u, u, u)
        return estimate_inner(V.reshape(-1, I ** 3)).reshape(u.shape[:-1])
    return tiuu, tuuu


def hcs_oracle(T: torch.Tensor, hashes: Sequence[ModeHash],
               use_kernel: Optional[bool] = None) -> Oracle:
    """HCS-based contraction (Shi 2019): contract the SKETCHED tensor with
    CS(u) directly, HCS(T)(I, CS2(u), CS3(u)), then decompress mode 1."""
    sk = hcs_general(T, hashes)                          # (D, J1, J2, J3)
    mh1, mh2, mh3 = hashes

    def tiuu(u):
        c2 = cs_apply_batch(u, mh2, use_kernel)          # (D, ..., J2)
        c3 = cs_apply_batch(u, mh3, use_kernel)
        z = torch.einsum("dabc,d...b,d...c->d...a", sk, c2, c3)
        z = z.reshape(mh1.D, -1, mh1.J)                  # (D, B, J1)
        est = unsketch_op(z.contiguous(), mh1.h, mh1.s, use_kernel)
        return median_combine(est).reshape(u.shape[:-1] + (mh1.I,))

    def tuuu(u):
        c1, c2, c3 = (cs_apply_batch(u, mh, use_kernel) for mh in hashes)
        return median_combine(torch.einsum("dabc,d...a,d...b,d...c->d...",
                                           sk, c1, c2, c3))
    return tiuu, tuuu


ORACLES = {
    "plain": plain_oracle,
    "fcs": fcs_oracle,
    "ts": ts_oracle,
    "cs": cs_oracle,
    "hcs": hcs_oracle,
}


# ---------------------------------------------------------------------------
# Symmetric RTPM
# ---------------------------------------------------------------------------


def _nan_safe_argmax(vals: torch.Tensor) -> torch.Tensor:
    """Best-of-inits selection that a divergent candidate cannot hijack:
    a power iteration that diverges under a noisy sketched oracle yields
    lambda = NaN or +/-inf, so non-finite candidates are demoted to -inf
    and a finite init wins whenever one exists."""
    return torch.argmax(torch.where(torch.isfinite(vals), vals,
                                    torch.full_like(vals, -torch.inf)))


def rtpm(tiuu: Callable, tuuu: Callable, I: int, rank: int,
         generator: Optional[torch.Generator] = None, n_inits: int = 15,
         n_iters: int = 20, inits: Optional[torch.Tensor] = None,
         device: Optional[torch.device] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (lambdas (rank,), factors (I, rank)).

    ``inits`` (rank, n_inits, I): the raw (unnormalized) initial vectors
    of each component; drawn from ``generator`` (CPU) when not given.
    Deflation subtracts each found rank-1 term analytically (the
    contractions are linear in T)."""
    lams, us = [], []

    def power(U, f):
        for _ in range(n_iters):
            V = f(U)
            U = V / (torch.linalg.vector_norm(V, dim=-1, keepdim=True)
                     + 1e-12)
        return U

    cur_tiuu, cur_tuuu = tiuu, tuuu
    for r in range(rank):
        raw = (inits[r] if inits is not None
               else torch.randn((n_inits, I), generator=generator))
        raw = raw.to(device=device, dtype=torch.float32)
        U0 = raw / torch.linalg.vector_norm(raw, dim=1, keepdim=True)
        cands = power(U0, cur_tiuu)
        best = _nan_safe_argmax(cur_tuuu(cands))
        u = power(cands[best], cur_tiuu)             # polish the best
        lam = cur_tuuu(u)
        lams.append(lam)
        us.append(u)

        # deflation: T <- T - lam u^3; the contractions update analytically
        def make_deflated(prev_tiuu, prev_tuuu, lam=lam, u=u):
            def d_tiuu(v):
                return prev_tiuu(v) - lam * u * ((v @ u)[..., None] ** 2)

            def d_tuuu(v):
                return prev_tuuu(v) - lam * (v @ u) ** 3
            return d_tiuu, d_tuuu

        cur_tiuu, cur_tuuu = make_deflated(cur_tiuu, cur_tuuu)

    return torch.stack(lams), torch.stack(us, dim=1)


def make_oracle(T: torch.Tensor, method: str, hashes=None,
                use_kernel: Optional[bool] = None) -> Oracle:
    """The method's contraction oracle over T (I, I, I) with the given
    hashes: one long ModeHash over I^3 entries for ``cs``, one per mode
    otherwise."""
    if method == "plain":
        return plain_oracle(T)
    return ORACLES[method](T, hashes, use_kernel)


def rtpm_hashes(I: int, method: str, hash_len: int, n_sketches: int,
                generator: Optional[torch.Generator], device):
    """The hashes ``rtpm_decompose`` draws for a method (None for
    ``plain``)."""
    if method == "plain":
        return None
    if method == "cs":
        return make_mode_hash(I ** 3, hash_len, n_sketches, generator,
                              device)
    return make_tensor_hashes((I, I, I), hash_len, n_sketches, generator,
                              device)


def rtpm_decompose(T: torch.Tensor, rank: int,
                   generator: Optional[torch.Generator] = None,
                   method: str = "plain", hash_len: int = 1000,
                   n_sketches: int = 2, n_inits: int = 15, n_iters: int = 20,
                   hashes=None, inits: Optional[torch.Tensor] = None,
                   use_kernel: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """End-to-end symmetric CPD of T (I, I, I) via (sketched) RTPM on T's
    device.  ``hashes`` default to ones drawn from ``generator``."""
    I = T.shape[0]
    if hashes is None:
        hashes = rtpm_hashes(I, method, hash_len, n_sketches, generator,
                             T.device)
    tiuu, tuuu = make_oracle(T, method, hashes, use_kernel)
    return rtpm(tiuu, tuuu, I, rank, generator, n_inits, n_iters, inits,
                T.device)


def cp_reconstruct(lams: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    return torch.einsum("r,ar,br,cr->abc", lams, U, U, U)


def residual_norm(T: torch.Tensor, lams: torch.Tensor,
                  U: torch.Tensor) -> torch.Tensor:
    return (torch.linalg.vector_norm(T - cp_reconstruct(lams, U))
            / torch.linalg.vector_norm(T))
