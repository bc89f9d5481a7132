"""A frozen copy of the hash arithmetic that the sketched optimizer's
tables use (multiply-add, then the MurmurHash3 finalizer, mod 2^32), and
of the rules that give each leaf its seed and width.  The reference works
every bucket and sign out again from these; it reads nothing the program
made.

Two forms of one function: ``*_exact`` carries uint32 values in int64,
as the published arithmetic is written; the fast form works in int32
with wrapping products (four times fewer bytes a pass), and
``check_fast_form`` holds it to the exact one before a run uses it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
MASK = 0xFFFFFFFF


def coeffs(seed: int, rows: int) -> np.ndarray:
    """(rows, 4) uint32 (a_bucket, b_bucket, a_sign, b_sign), a's odd."""
    rng = np.random.RandomState(np.uint32(seed) ^ 0x5EEDC0DE)
    c = rng.randint(0, 2 ** 31, size=(rows, 4)).astype(np.uint64)
    return ((c * 2 + 1) % (2 ** 32)).astype(np.uint32)


def leaf_seed(seed: int, i: int) -> int:
    """Seed of a leaf's tables: the m table of leaf i takes 2i, v 2i + 1."""
    return (int(seed) * 1_000_003 + i) % (1 << 31)


def cols_for(numel: int, ratio: int, rows: int) -> int:
    """Table width: numel / (rows ratio), rounded up to 128 (256 when
    2048 or more)."""
    c = -(-numel // (rows * ratio))
    align = 256 if c >= 2048 else 128
    return -(-c // align) * align


# -- exact form (int64 holding uint32) ----------------------------------


def _mix_exact(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * M1) & MASK
    x = x ^ (x >> 13)
    x = (x * M2) & MASK
    return x ^ (x >> 16)


def _affine_exact(idx: torch.Tensor, a: int, b: int) -> torch.Tensor:
    lo = (a & 0xFFFF) * idx
    hi = (((a >> 16) * idx) & 0xFFFF) << 16
    return (lo + hi + b) & MASK


def bucket_exact(idx: torch.Tensor, a: int, b: int, c: int) -> torch.Tensor:
    return _mix_exact(_affine_exact(idx & MASK, a, b)) % c


def sign_exact(idx: torch.Tensor, a: int, b: int) -> torch.Tensor:
    bit = _mix_exact(_affine_exact(idx & MASK, a, b)) >> 31
    return 1.0 - 2.0 * bit.to(torch.float32)


# -- fast form (int32, wrapping) ------------------------------------------


def _s32(v: int) -> int:
    v &= MASK
    return v - (1 << 32) if v >= (1 << 31) else v


def u32_bits(idx: torch.Tensor) -> torch.Tensor:
    """int64 coordinates (< 2^32) as the int32 holding their bits."""
    v = idx & MASK
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _mixed(x32: torch.Tensor, a: int, b: int) -> torch.Tensor:
    x = x32 * _s32(a) + _s32(b)
    x = x ^ ((x >> 16) & 0xFFFF)
    x = x * _s32(M1)
    x = x ^ ((x >> 13) & 0x7FFFF)
    x = x * _s32(M2)
    return x ^ ((x >> 16) & 0xFFFF)


def bucket(x32: torch.Tensor, a: int, b: int, c: int) -> torch.Tensor:
    return (_mixed(x32, a, b).to(torch.int64) & MASK) % c


def sign(x32: torch.Tensor, a: int, b: int) -> torch.Tensor:
    return torch.where(_mixed(x32, a, b) < 0, -1.0, 1.0)


def check_fast_form(co: np.ndarray, c: int, numel: int, device) -> None:
    """The fast form equals the exact one on a spread of coordinates of a
    leaf of ``numel`` elements (its ends included)."""
    n = min(numel, 1 << 20)
    idx = torch.unique(torch.cat([
        torch.linspace(0, numel - 1, n, device=device).to(torch.int64),
        torch.tensor([0, numel - 1], device=device)]))
    x32 = u32_bits(idx)
    for r in range(co.shape[0]):
        a, b, sa, sb = (int(v) for v in co[r])
        if not (torch.equal(bucket(x32, a, b, c), bucket_exact(idx, a, b, c))
                and torch.equal(sign(x32, sa, sb), sign_exact(idx, sa, sb))):
            raise RuntimeError(f"fast hash form disagrees with the exact "
                               f"one (row {r}, {c} columns)")


def row_hashes(co: np.ndarray, x32: torch.Tensor, c: int, signed: bool
               ) -> Tuple[list, list]:
    """Per row: buckets (int64) and signs (f32; None unsigned)."""
    bks, sgs = [], []
    for r in range(co.shape[0]):
        a, b, sa, sb = (int(v) for v in co[r])
        bks.append(bucket(x32, a, b, c))
        sgs.append(sign(x32, sa, sb) if signed else None)
    return bks, sgs
