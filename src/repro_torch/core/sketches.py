"""TS (Def. 2), HCS (Def. 3) and FCS (Def. 4) for general tensors and for
CP-form tensors (the port of ``repro/core/sketches.py``).

All sketches carry a leading D axis (independent repetitions, combined
by the median in estimators.py).

General tensors: every repetition's combined position
sum_n h_n(i_n) (mod J for TS) and sign prod_n s_n(i_n) are broadcast on
the fly, and the signed tensor is scatter-added in one ``index_add_``
over all D repetitions (no stored long hash pair).  HCS contracts each
mode with its signed one-hot.  These sit outside any kernel in the
reference and stay plain torch here.

CP-form tensors (Eqs. 3, 5, 8): per-mode CS of the factor columns
(``cs_apply_cols``, the count-sketch kernel), then FFT-domain products:
circular J-point (TS), zero-padded J~-point (FCS), or the materialized
outer product (HCS).  FFTs are ``torch.fft`` (cuFFT on the card).

Decompression reads the sketch through ``unsketch_op`` (the Hopper
``unsketch`` kernel for CUDA tensors) with each repetition's combined
(position, sign) as its table.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.count_sketch import cs_apply_cols
from repro_torch.core.hashes import ModeHash, fcs_sketch_len
from repro_torch.kernels.ops import unsketch_op

# ---------------------------------------------------------------------------
# General tensors
# ---------------------------------------------------------------------------


def _sketch_general(T: torch.Tensor, hashes: Sequence[ModeHash],
                    circular: bool) -> torch.Tensor:
    N = T.ndim
    D = hashes[0].D
    Js = [mh.J for mh in hashes]
    out_len = Js[0] if circular else fcs_sketch_len(Js)
    pos = torch.zeros((D,) + (1,) * N, dtype=torch.int64, device=T.device)
    sign = torch.ones((D,) + (1,) * N, dtype=T.dtype, device=T.device)
    for n, mh in enumerate(hashes):
        bshape = (D,) + tuple(mh.I if m == n else 1 for m in range(N))
        pos = pos + mh.h.reshape(bshape)
        sign = sign * mh.s.reshape(bshape).to(T.dtype)
    if circular:
        pos = pos % out_len
    pos = pos + out_len * torch.arange(D, device=T.device).reshape(
        (D,) + (1,) * N)
    out = torch.zeros(D * out_len, dtype=T.dtype, device=T.device)
    out.index_add_(0, pos.reshape(-1), (sign * T).reshape(-1))
    return out.reshape(D, out_len)


def ts_general(T: torch.Tensor, hashes: Sequence[ModeHash]) -> torch.Tensor:
    """Tensor Sketch of a dense tensor: (D, J)."""
    return _sketch_general(T, hashes, circular=True)


def fcs_general(T: torch.Tensor, hashes: Sequence[ModeHash]) -> torch.Tensor:
    """Fast Count Sketch of a dense tensor (Eq. 13): (D, J~)."""
    return _sketch_general(T, hashes, circular=False)


def hcs_general(T: torch.Tensor, hashes: Sequence[ModeHash]) -> torch.Tensor:
    """Higher-order Count Sketch (Eq. 4): (D, J_1, ..., J_N)."""
    outs = []
    for d in range(hashes[0].D):
        out = T
        for n, mh in enumerate(hashes):
            onehot = (torch.nn.functional.one_hot(mh.h[d].long(), mh.J)
                      .to(T.dtype) * mh.s[d][:, None].to(T.dtype))
            out = torch.movedim(torch.tensordot(out, onehot, dims=([n], [0])),
                                -1, n)
        outs.append(out)
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# CP-form tensors  T = [[lambda; U^(1), ..., U^(N)]]
# ---------------------------------------------------------------------------


def conv_sketch(cols: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """Product of the per-mode CS'd columns (D, J_n, R) in the n-point
    FFT domain, back to (D, n, R): the circular (n = J) or zero-padded
    linear (n = J~) convolution of the columns."""
    f = torch.fft.rfft(cols[0], n=n, dim=1)
    for sk in cols[1:]:
        f = f * torch.fft.rfft(sk, n=n, dim=1)
    return torch.fft.irfft(f, n=n, dim=1)


def _cs_factors(Us: Sequence[torch.Tensor], hashes: Sequence[ModeHash],
                use_kernel: Optional[bool]):
    return [cs_apply_cols(U, mh, use_kernel) for U, mh in zip(Us, hashes)]


def ts_cp(lam: torch.Tensor, Us: Sequence[torch.Tensor],
          hashes: Sequence[ModeHash],
          use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Eq. 3: mode-J circular convolution via J-point FFT.  (D, J)."""
    conv = conv_sketch(_cs_factors(Us, hashes, use_kernel), hashes[0].J)
    return torch.einsum("djr,r->dj", conv, lam)


def fcs_cp(lam: torch.Tensor, Us: Sequence[torch.Tensor],
           hashes: Sequence[ModeHash],
           use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Eq. 8: zero-padded linear convolution via J~-point FFT.  (D, J~)."""
    Jt = fcs_sketch_len([mh.J for mh in hashes])
    conv = conv_sketch(_cs_factors(Us, hashes, use_kernel), Jt)
    return torch.einsum("djr,r->dj", conv, lam)


def hcs_cp(lam: torch.Tensor, Us: Sequence[torch.Tensor],
           hashes: Sequence[ModeHash],
           use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Eq. 5: materialized outer product of CS'd factors (the slow one,
    O(R prod J_n)).  Supports N in {2, 3, 4}."""
    sk = _cs_factors(Us, hashes, use_kernel)
    subs = {2: "dar,dbr,r->dab", 3: "dar,dbr,dcr,r->dabc",
            4: "dar,dbr,dcr,der,r->dabce"}
    if len(sk) not in subs:
        raise NotImplementedError(len(sk))
    return torch.einsum(subs[len(sk)], *sk, lam)


# ---------------------------------------------------------------------------
# Decompression
# ---------------------------------------------------------------------------


def signed_lookup(sk: torch.Tensor, pos: torch.Tensor, sign: torch.Tensor,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """``sign[d] * sk[d][pos[d]]`` for (D, ...) positions and signs into
    the flat (D, L) sketch, through ``unsketch_op``: (D, ...)."""
    D = sk.shape[0]
    est = unsketch_op(sk.reshape(D, 1, -1).contiguous(),
                      pos.reshape(D, -1).to(torch.int32).contiguous(),
                      sign.reshape(D, -1).contiguous(), use_kernel)
    return est.reshape(pos.shape)


def _combined(hashes: Sequence[ModeHash], idx: Sequence[torch.Tensor]):
    """Each repetition's combined position (list per mode) and sign at the
    broadcast index arrays ``idx``: (D, *shape)."""
    shape = torch.broadcast_shapes(*(ix.shape for ix in idx))
    D = hashes[0].D
    pos = [mh.h[:, ix].expand((D,) + shape) for mh, ix in zip(hashes, idx)]
    sign = torch.ones((D,) + shape, dtype=torch.float32,
                      device=hashes[0].s.device)
    for mh, ix in zip(hashes, idx):
        sign = sign * mh.s[:, ix]
    return pos, sign


def fcs_decompress_entry(sk: torch.Tensor, hashes: Sequence[ModeHash],
                         idx: Sequence[torch.Tensor],
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Entries of the original tensor from its FCS sketch (paper Section
    4.3).  ``idx``: one integer array per mode, broadcastable to the
    output shape.  Returns (D, ...) estimates (the median over D is the
    caller's)."""
    pos, sign = _combined(hashes, idx)
    return signed_lookup(sk, sum(pos[1:], pos[0]), sign, use_kernel)


def hcs_decompress_entry(sk: torch.Tensor, hashes: Sequence[ModeHash],
                         idx: Sequence[torch.Tensor],
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """HCS decompression: prod_n s_n * HCS[h_1(i_1), ..., h_N(i_N)], read
    at the flat (row-major) position of the bucket tuple."""
    pos, sign = _combined(hashes, idx)
    flat = pos[0].to(torch.int64)
    for p, mh in zip(pos[1:], hashes[1:]):
        flat = flat * mh.J + p
    return signed_lookup(sk, flat, sign, use_kernel)
