"""uint32 hash family for sketch containers (port of
``repro/sketch/hashing.py``).

Multiply-add then the MurmurHash3 finalizer, with mod-2^32 wraparound.
Torch on the CPU has no uint32 ``>>``, ``%`` or ``+``, so every value is
carried in int64 and masked back to 32 bits with ``& 0xFFFFFFFF`` after
each operation that can overflow; the results are bitwise the
reference's.  Coefficients come from numpy ``RandomState`` exactly as in
the reference, so both packages hash identically for one seed.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_MASK = 0xFFFFFFFF


def make_coeffs(seed: int, rows: int) -> np.ndarray:
    """(rows, 4) uint32: (a_bucket, b_bucket, a_sign, b_sign); a's odd."""
    rng = np.random.RandomState(np.uint32(seed) ^ 0x5EEDC0DE)
    c = rng.randint(0, 2 ** 31, size=(rows, 4)).astype(np.uint64)
    c = (c * 2 + 1) % (2 ** 32)          # odd multipliers (and odd b: fine)
    return c.astype(np.uint32)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 fmix32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * _M1) & _MASK
    x = x ^ (x >> 13)
    x = (x * _M2) & _MASK
    x = x ^ (x >> 16)
    return x


def _affine(idx: torch.Tensor, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    # a, idx < 2^32: a * idx < 2^64 overflows int64 — split a in halves
    # so every partial product stays below 2^48 before masking
    lo = (a & 0xFFFF) * idx
    hi = (((a >> 16) * idx) & 0xFFFF) << 16
    return (lo + hi + b) & _MASK


def bucket_hash(idx: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: int) -> torch.Tensor:
    """Buckets in [0, c) for (possibly broadcast) uint32 indices."""
    return (mix32(_affine(idx, a, b)) % c).to(torch.int32)


def sign_hash(idx: torch.Tensor, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """Signs in {-1.0, +1.0} (f32) from the top mixed bit."""
    bit = (mix32(_affine(idx, a, b)) >> 31).to(torch.float32)
    return 1.0 - 2.0 * bit


def row_buckets_signs(coeffs: torch.Tensor, idx: torch.Tensor, c: int,
                      signed: bool):
    """(rows, n) buckets and signs for an int index vector.
    ``coeffs`` is the (rows, 4) coefficient array as int64.
    ``signed=False`` (count-min mode) returns all-ones signs."""
    u = (idx.to(torch.int64) & _MASK)[None, :]
    bk = bucket_hash(u, coeffs[:, 0:1], coeffs[:, 1:2], c)
    if signed:
        sg = sign_hash(u, coeffs[:, 2:3], coeffs[:, 3:4])
    else:
        sg = torch.ones(bk.shape, dtype=torch.float32, device=bk.device)
    return bk, sg


@functools.lru_cache(maxsize=None)
def _cached_coeffs_np(seed: int, rows: int) -> np.ndarray:
    return make_coeffs(seed, rows)


def cached_coeffs(seed: int, rows: int, device=None) -> torch.Tensor:
    """Coefficients for (seed, rows) as an int64 tensor (cached host-side)."""
    return torch.as_tensor(_cached_coeffs_np(int(seed), int(rows)).astype(
        np.int64), device=device)
