"""Sketched tensor-contraction approximations, paper Sections 3.3 and 4.3
(the port of ``repro/core/contraction.py``).

  T(u,u,u)   ~= < FCS(T), FCS(u o u o u) >                         (Eq. 16)
  T(I,u,u)_i ~= s_1(i) * z[h_1(i)],                                 (Eq. 17)
      z = irfft( rfft(FCS(T)) * conj(rfft(CS_2(u), J~))
                               * conj(rfft(CS_3(u), J~)) )

plus the Kronecker-product (Section 4.3.1) and mode-contraction (Section
4.3.2) compress / decompress rules, and the TS equivalents.  The
contractions take one vector u (I,) as the reference does, or a batch
(B, I), each row its own contraction (RTPM runs its L inits as one
batch): the results gain a B axis after D.  CS applies go through the
count-sketch kernel and every lookup through the unsketch kernel
(core/count_sketch.py, sketches.signed_lookup).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.count_sketch import cs_apply_batch
from repro_torch.core.estimators import median_combine
from repro_torch.core.hashes import ModeHash, fcs_sketch_len
from repro_torch.core.sketches import conv_sketch, fcs_general, signed_lookup
from repro_torch.kernels.ops import unsketch_op

# ---------------------------------------------------------------------------
# T(u, u, u)
# ---------------------------------------------------------------------------


def _tuuu(sk_T: torch.Tensor, u: torch.Tensor, hashes: Sequence[ModeHash],
          n: int, use_kernel: Optional[bool]) -> torch.Tensor:
    U = u.reshape(-1, u.shape[-1])                       # (B, I)
    cols = [cs_apply_batch(U, mh, use_kernel).transpose(1, 2)
            for mh in hashes]                            # (D, J, B)
    sk_u = conv_sketch(cols, n)                          # (D, n, B)
    out = torch.einsum("dj,djb->db", sk_T, sk_u)
    return out[:, 0] if u.ndim == 1 else out


def fcs_tuuu(sk_T: torch.Tensor, u: torch.Tensor,
             hashes: Sequence[ModeHash],
             use_kernel: Optional[bool] = None) -> torch.Tensor:
    """<FCS(T), FCS(u o u o u)> per repetition: (D,) or (D, B)."""
    return _tuuu(sk_T, u, hashes, fcs_sketch_len([mh.J for mh in hashes]),
                 use_kernel)


def ts_tuuu(sk_T: torch.Tensor, u: torch.Tensor,
            hashes: Sequence[ModeHash],
            use_kernel: Optional[bool] = None) -> torch.Tensor:
    return _tuuu(sk_T, u, hashes, hashes[0].J, use_kernel)


# ---------------------------------------------------------------------------
# T(I, u, u)
# ---------------------------------------------------------------------------


def correlate(sk_T: torch.Tensor, cs_b: torch.Tensor, cs_c: torch.Tensor,
              n: int) -> torch.Tensor:
    """z = irfft(rfft(sk_T) conj(rfft(cs_b)) conj(rfft(cs_c))), all n-point:
    sk_T (D, n), cs_b / cs_c (D, B, J) -> (D, B, n)."""
    f = (torch.fft.rfft(sk_T, n=n, dim=-1)[:, None, :]
         * torch.conj(torch.fft.rfft(cs_b, n=n, dim=-1))
         * torch.conj(torch.fft.rfft(cs_c, n=n, dim=-1)))
    return torch.fft.irfft(f, n=n, dim=-1)


def _tiuu(sk_T: torch.Tensor, u: torch.Tensor, hashes: Sequence[ModeHash],
          circular: bool, use_kernel: Optional[bool]) -> torch.Tensor:
    n = sk_T.shape[-1]
    mh1, mh2, mh3 = hashes
    U = u.reshape(-1, u.shape[-1])
    z = correlate(sk_T, cs_apply_batch(U, mh2, use_kernel),
                  cs_apply_batch(U, mh3, use_kernel), n)     # (D, B, n)
    h = mh1.h % n if circular else mh1.h
    est = unsketch_op(z.contiguous(), h, mh1.s, use_kernel)  # (D, B, I1)
    return est[:, 0] if u.ndim == 1 else est


def fcs_tiuu(sk_T: torch.Tensor, u: torch.Tensor,
             hashes: Sequence[ModeHash],
             use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Eq. 17.  sk_T: (D, J~).  Per-repetition estimates (D, I_1), or
    (D, B, I_1) for a batch of vectors."""
    return _tiuu(sk_T, u, hashes, False, use_kernel)


def ts_tiuu(sk_T: torch.Tensor, u: torch.Tensor,
            hashes: Sequence[ModeHash],
            use_kernel: Optional[bool] = None) -> torch.Tensor:
    """TS analogue (Wang et al. 2015): circular correlation, mod-J lookup."""
    return _tiuu(sk_T, u, hashes, True, use_kernel)


# ---------------------------------------------------------------------------
# Kronecker-product compression (Section 4.3.1)
# ---------------------------------------------------------------------------


def _grid4(hashes: Sequence[ModeHash]):
    """Each repetition's combined position and sign on the full 4-mode
    index grid: (D, I1, I2, I3, I4) int32 and f32, materialized as the
    reference materializes them."""
    D = hashes[0].D
    pos = torch.zeros((D, 1, 1, 1, 1), dtype=torch.int32,
                      device=hashes[0].h.device)
    sign = torch.ones((D, 1, 1, 1, 1), dtype=torch.float32,
                      device=hashes[0].h.device)
    for n, mh in enumerate(hashes):
        bshape = (D,) + tuple(mh.I if m == n else 1 for m in range(4))
        pos = pos + mh.h.reshape(bshape)
        sign = sign * mh.s.reshape(bshape)
    return pos, sign


def fcs_kron_compress(A: torch.Tensor, B: torch.Tensor,
                      hashes: Sequence[ModeHash]) -> torch.Tensor:
    """FCS(A (x) B) from the factors: convolve the two 2-mode FCS sketches.
    hashes = (h1..h4) for (rows(A), cols(A), rows(B), cols(B)).  Returns
    (D, J~), J~ = sum J_n - 3."""
    Jt = fcs_sketch_len([mh.J for mh in hashes])
    f = (torch.fft.rfft(fcs_general(A, hashes[:2]), n=Jt, dim=-1)
         * torch.fft.rfft(fcs_general(B, hashes[2:]), n=Jt, dim=-1))
    return torch.fft.irfft(f, n=Jt, dim=-1)


def fcs_kron_decompress(sk: torch.Tensor, hashes: Sequence[ModeHash],
                        shapeA: Tuple[int, int], shapeB: Tuple[int, int],
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Median-of-D estimate of A (x) B: (I1 I3, I2 I4)."""
    I1, I2 = shapeA
    I3, I4 = shapeB
    est = median_combine(signed_lookup(sk, *_grid4(hashes),
                                       use_kernel=use_kernel))
    # (i1, i2, i3, i4) -> Kron layout (I3 i1 + i3, I4 i2 + i4)
    return est.permute(0, 2, 1, 3).reshape(I1 * I3, I2 * I4)


# ---------------------------------------------------------------------------
# Mode-contraction compression (Section 4.3.2): A (I1,I2,L) x_3,1 B (L,I3,I4)
# ---------------------------------------------------------------------------


def fcs_contraction_compress(A: torch.Tensor, B: torch.Tensor,
                             hashes: Sequence[ModeHash]) -> torch.Tensor:
    """FCS(A o_{3,1} B) = sum_l conv(FCS(A[:,:,l]), FCS(B[l])), summed in
    the frequency domain (one irfft in all)."""
    Jt = fcs_sketch_len([mh.J for mh in hashes])
    f = None
    for l in range(A.shape[-1]):
        fl = (torch.fft.rfft(fcs_general(A[:, :, l], hashes[:2]), n=Jt,
                             dim=-1)
              * torch.fft.rfft(fcs_general(B[l], hashes[2:]), n=Jt, dim=-1))
        f = fl if f is None else f + fl
    return torch.fft.irfft(f, n=Jt, dim=-1)


def fcs_contraction_decompress(sk: torch.Tensor, hashes: Sequence[ModeHash],
                               shape: Tuple[int, int, int, int],
                               use_kernel: Optional[bool] = None
                               ) -> torch.Tensor:
    """Median-of-D estimate of the (I1, I2, I3, I4) contraction result."""
    est = signed_lookup(sk, *_grid4(hashes), use_kernel=use_kernel)
    return median_combine(est).reshape(shape)
