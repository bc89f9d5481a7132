"""2-wise independent hash families for sketching (the port of
``repro/core/hashes.py``).

FCS/TS/HCS keep one short hash pair per mode, O(sum I_n), where CS on
vec(T) needs one pair of length prod I_n.  The family is affine mod the
Mersenne prime p = 2^31 - 1: h(i) = ((a i + b) mod p) mod J and
s(i) = 1 - 2 (((a' i + b') mod p) mod 2).  D independent repetitions
stack on a leading axis.

The reference draws its coefficients with ``jax.random``; the port draws
them from an explicit ``torch.Generator`` (CPU), so the two never share
draws from a seed.  ``mode_hash_from_coeffs`` builds the tables from given
coefficients, bitwise the reference's for the same coefficients
(``models/bridge.py:mode_hashes_from_reference`` carries the reference's
hashes across).  Tables are evaluated in int64: a < 2^31 and i < 2^31,
so a i + b < 2^62 and nothing overflows.

A ``ModeHash`` also holds the bucket links of its tables (each entry's
next entry of its tile in the same bucket, and its sign), the
count-sketch kernel's order of additions; they are built once, with the
tables, on their device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.count_sketch import Index, bucket_links

PRIME = 2_147_483_647  # 2^31 - 1


@dataclasses.dataclass(frozen=True, eq=False)
class ModeHash:
    """Hash pair (h: [I] -> [J], s: [I] -> {+-1}) x D repetitions."""
    h: torch.Tensor        # (D, I) int32 in [0, J)
    s: torch.Tensor        # (D, I) float32 in {+1, -1}
    coeffs: torch.Tensor   # (D, 4) int64: (ah, bh, as_, bs), each < 2^31
    J: int
    links: torch.Tensor    # (D, I) int16: kernels/count_sketch.py:bucket_links

    @property
    def D(self) -> int:
        return self.h.shape[0]

    @property
    def I(self) -> int:
        return self.h.shape[1]

    @property
    def index(self) -> Index:
        return self.links


def mode_hash_from_coeffs(coeffs: torch.Tensor, I: int, J: int,
                          device: DeviceLike = None) -> ModeHash:
    """Tables over I entries from (D, 4) coefficients (ah, bh, as_, bs),
    ah, as_ in [1, p) and bh, bs in [0, p)."""
    dev = resolve_device(device)
    if not 0 < I < 2 ** 31 or not 0 < J < 2 ** 31:
        raise ValueError(f"I={I}, J={J}: both must lie in [1, 2^31)")
    c = torch.as_tensor(coeffs, dtype=torch.int64).to(dev)
    if c.ndim != 2 or c.shape[1] != 4 or bool(
            ((c < 0) | (c >= 2 ** 31)).any()):
        raise ValueError("coeffs must be (D, 4) values in [0, 2^31)")
    idx = torch.arange(I, dtype=torch.int64, device=dev)
    h = ((c[:, 0:1] * idx + c[:, 1:2]) % PRIME) % J
    s = 1.0 - 2.0 * (((c[:, 2:3] * idx + c[:, 3:4]) % PRIME) % 2).to(
        torch.float32)
    h = h.to(torch.int32)
    return ModeHash(h=h, s=s, coeffs=c, J=int(J),
                    links=bucket_links(h, s, J))


def make_mode_hash(I: int, J: int, D: int = 1,
                   generator: torch.Generator = None,
                   device: DeviceLike = None) -> ModeHash:
    """Draw D coefficient rows from ``generator`` (a CPU generator) and
    tabulate them on ``device``."""
    cols = [torch.randint(lo, PRIME, (D,), generator=generator)
            for lo in (1, 0, 1, 0)]
    return mode_hash_from_coeffs(torch.stack(cols, dim=-1), I, J, device)


def make_tensor_hashes(dims: Sequence[int], Js: Union[Sequence[int], int],
                       D: int = 1, generator: torch.Generator = None,
                       device: DeviceLike = None) -> Tuple[ModeHash, ...]:
    """One ModeHash per tensor mode."""
    if isinstance(Js, int):
        Js = [Js] * len(dims)
    return tuple(make_mode_hash(I, J, D, generator, device)
                 for I, J in zip(dims, Js))


def fcs_sketch_len(Js: Sequence[int]) -> int:
    """J~ = sum_n J_n - N + 1 (length of the linear-convolution sketch)."""
    return int(sum(Js) - len(Js) + 1)


def combined_fcs_hash(hashes: Sequence[ModeHash]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The structured long pair (Eq. 7) on the full index grid (row-major,
    last mode fastest, matching ``T.reshape(-1)``): (D, prod I_n) int32
    positions and f32 signs.  For tests and small tensors only; no path
    builds it."""
    D, N = hashes[0].D, len(hashes)
    dev = hashes[0].h.device
    h_tot = torch.zeros((D,) + (1,) * N, dtype=torch.int32, device=dev)
    s_tot = torch.ones((D,) + (1,) * N, dtype=torch.float32, device=dev)
    for n, mh in enumerate(hashes):
        bshape = (D,) + tuple(mh.I if m == n else 1 for m in range(N))
        h_tot = h_tot + mh.h.reshape(bshape)
        s_tot = s_tot * mh.s.reshape(bshape)
    return h_tot.reshape(D, -1), s_tot.reshape(D, -1)


def storage_bytes_tabulated(hashes: Sequence[ModeHash]) -> int:
    """Hash memory if stored as tables (the paper's Figs. 5/6 metric)."""
    return sum(mh.h.numel() * 4 + mh.s.numel() * 4 for mh in hashes)


def storage_bytes_cs_long(dims: Sequence[int], D: int) -> int:
    """What CS on vec(T) would need: one pair of length prod(dims)."""
    n = 1
    for d in dims:
        n *= d
    return n * D * 8
