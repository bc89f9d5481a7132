"""Count-sketch vector container (port of ``repro/sketch/csvec.py``).

Both estimate modes of the reference:

  signed=True  — count sketch: signed accumulate, median-of-rows estimate
                 (the sketched optimizer's first moment);
  signed=False — count-min: unsigned accumulate, min-of-rows estimate
                 (the optimizer's second moment and the serve path's
                 prefix-cache admission counter).

Every exported function of the reference: ``csvec_zeros``, dense
``accumulate``, ``accumulate_coords``, ``query`` / ``query_row`` /
``query_all``, ``topk``, ``l2_estimate``, ``merge``, ``scale``,
``decay`` and ``state_bytes``.  The signed median is numpy's (the two
middle rows averaged when the row count is even), as ``jnp.median``
computes it; ``torch.median`` returns the lower middle value and is not
used.

The container holds only the (rows, cols) f32 table and the (rows, 4)
hash coefficients; bucket hashes are recomputed on the fly
(sketch/hashing.py).  Updates (``accumulate``, ``scale``, ``decay``) are in place: the JAX
container was functional, here the one owner mutates its table;
``merge`` of two containers returns a new one.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.sketch.hashing import cached_coeffs, row_buckets_signs


@dataclasses.dataclass
class CSVec:
    table: torch.Tensor       # (rows, cols) f32
    coeffs: torch.Tensor      # (rows, 4) int64 holding uint32 coefficients
    d: int                    # dimensionality of the sketched vector
    signed: bool              # count-sketch (True) vs count-min (False)
    seed: int = 0

    @property
    def rows(self) -> int:
        return self.table.shape[0]

    @property
    def cols(self) -> int:
        return self.table.shape[1]


def csvec_zeros(d: int, cols: int, rows: int = 3, seed: int = 0,
                signed: bool = True, device=None) -> CSVec:
    """Empty sketch for a d-vector: (rows, cols) zeros + cached coeffs."""
    return CSVec(table=torch.zeros((rows, cols), dtype=torch.float32,
                                   device=device),
                 coeffs=cached_coeffs(seed, rows, device=device), d=int(d),
                 signed=signed, seed=int(seed))


def accumulate(sk: CSVec, vec: torch.Tensor, offset: int = 0) -> CSVec:
    """In place: sk + CS(vec), every coordinate of a dense vector.  The
    vector's element j is coordinate ``offset + j`` of the sketched
    d-vector, so the pieces of one vector can be added one at a time."""
    flat = vec.reshape(-1).to(torch.float32)
    idx = offset + torch.arange(flat.shape[0], dtype=torch.int64,
                                device=flat.device)
    return accumulate_coords(sk, idx, flat)


def index_add_ordered_(out: torch.Tensor, index: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """``out[index[j]] += values[j]`` for a 1-D ``out``, in place, in an
    order fixed by the data alone.  On the CPU ``index_add_`` adds a
    cell's terms one at a time in j order; on the card an accumulating
    ``index_put_`` sorts the cells stably and one warp sums each cell's
    run (j order) with a fixed reduction, with no atomics.
    (``index_add_`` and ``scatter_add_`` add on the card with f32 atomics,
    in an order that changes from run to run, and an accumulating
    ``index_put_`` on the CPU adds from several threads.)"""
    if out.device.type == "cpu":
        return out.index_add_(0, index, values)
    return out.index_put_((index,), values, accumulate=True)


def accumulate_coords(sk: CSVec, idx: torch.Tensor,
                      vals: torch.Tensor) -> CSVec:
    """Sparse accumulate, in place: add vals[j] at coordinates idx[j], in
    a fixed order (``index_add_ordered_``), so two runs agree bitwise on
    the card too."""
    bk, sg = row_buckets_signs(sk.coeffs, idx, sk.cols, sk.signed)
    upd = sg * vals.to(torch.float32)[None, :]
    cells = bk.to(torch.int64) + sk.cols * torch.arange(
        sk.rows, device=bk.device)[:, None]
    index_add_ordered_(sk.table.view(-1), cells.reshape(-1),
                       upd.reshape(-1))
    return sk


def median_rows(est: torch.Tensor) -> torch.Tensor:
    """Median over dim 0, numpy's: the middle value for an odd count, the
    mean of the two middle values for an even one.  Sorted by the same
    odd-even transposition network as the TPU kernel's ``_median_rows``
    and the CUDA kernel's retrieve pass (only elementwise min / max)."""
    rows = list(est.unbind(0))
    R = len(rows)
    for p in range(R):
        for j in range(p % 2, R - 1, 2):
            lo = torch.minimum(rows[j], rows[j + 1])
            hi = torch.maximum(rows[j], rows[j + 1])
            rows[j], rows[j + 1] = lo, hi
    if R % 2:
        return rows[R // 2]
    return 0.5 * (rows[R // 2 - 1] + rows[R // 2])


def _row_estimates(sk: CSVec, idx: torch.Tensor) -> torch.Tensor:
    """(rows, n) per-row estimates at idx: each row's signed cell."""
    bk, sg = row_buckets_signs(sk.coeffs, idx, sk.cols, sk.signed)
    return torch.gather(sk.table, 1, bk.to(torch.int64)) * sg


def query(sk: CSVec, idx: torch.Tensor) -> torch.Tensor:
    """Point estimates at idx: median of rows (signed) / min (unsigned)."""
    est = _row_estimates(sk, idx)
    if sk.signed:
        return median_rows(est)
    return est.min(dim=0).values


def query_row(sk: CSVec, idx: torch.Tensor, row: int) -> torch.Tensor:
    """Single-row estimate at idx (no median combine): the r = 1
    baseline."""
    return _row_estimates(sk, idx)[row]


def query_all(sk: CSVec) -> torch.Tensor:
    """Estimates for all d coordinates."""
    return query(sk, torch.arange(sk.d, dtype=torch.int64,
                                  device=sk.table.device))


def topk(sk: CSVec, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heavy hitters: (indices, estimates) of the k largest |estimate|.
    Ties may come in another order than ``jax.lax.top_k``'s."""
    est = query_all(sk)
    ix = torch.topk(est.abs(), k).indices
    return ix, est[ix]


def l2_estimate(sk: CSVec) -> torch.Tensor:
    """||vec||_2 estimate: the median over rows of per-row table norms
    (squared, then the root)."""
    return torch.sqrt(median_rows(sk.table.square().sum(dim=1)))


def merge(a: CSVec, b: CSVec) -> CSVec:
    """A new sketch of the sum of the two underlying vectors.  Needs
    identical hashes, checked through (d, signed, seed) and the table
    shape, as the reference checks them."""
    if (a.d, a.signed, a.seed) != (b.d, b.signed, b.seed) \
            or a.table.shape != b.table.shape:
        raise ValueError("CSVec mismatch: incompatible containers "
                         f"(d/signed/seed/shape {a.d}/{a.signed}/{a.seed}/"
                         f"{tuple(a.table.shape)} vs {b.d}/{b.signed}/"
                         f"{b.seed}/{tuple(b.table.shape)})")
    return dataclasses.replace(a, table=a.table + b.table)


def scale(sk: CSVec, alpha) -> CSVec:
    """In place: every cell times ``alpha`` (the sketch of alpha x vec)."""
    sk.table.mul_(alpha)
    return sk


def decay(sk: CSVec, factor: float = 0.5) -> CSVec:
    """Age the sketch in place: multiply all cells by ``factor`` and, for
    a count-min table, floor to keep integer-count semantics (see the
    reference's ``decay``)."""
    sk.table.mul_(torch.tensor(factor, dtype=torch.float32))
    if not sk.signed:
        sk.table.floor_()
    return sk


def state_bytes(sk: CSVec) -> int:
    """Persistent bytes: table + coefficients, counted at the reference's
    widths (f32 table, uint32 coefficients)."""
    return sk.table.numel() * sk.table.element_size() + sk.coeffs.numel() * 4
