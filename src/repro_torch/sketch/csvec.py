"""Count-sketch vector container (port of ``repro/sketch/csvec.py``),
reduced to what the serve path's prefix cache uses: the count-min mode
(``signed=False``) with ``accumulate_coords``, ``query`` (min of rows),
``decay`` and ``state_bytes``.  The signed median estimate and ``topk``
come with sketched KV and the sketched optimizer (ROADMAP Queue 1
#9 and #13).

The container holds only the (rows, cols) f32 table and the (rows, 4)
hash coefficients; bucket hashes are recomputed on the fly
(sketch/hashing.py).  Updates are in place: the JAX container was
functional, here the one owner mutates its table.
"""
from __future__ import annotations

import dataclasses

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
    def cols(self) -> int:
        return self.table.shape[1]


def csvec_zeros(d: int, cols: int, rows: int = 3, seed: int = 0,
                signed: bool = True, device=None) -> CSVec:
    """Empty sketch for a d-vector: (rows, cols) zeros + cached coeffs."""
    if signed:
        raise NotImplementedError(
            "signed (median) CSVec is not ported yet; see ROADMAP Queue 1 "
            "#9 and #13")
    return CSVec(table=torch.zeros((rows, cols), dtype=torch.float32,
                                   device=device),
                 coeffs=cached_coeffs(seed, rows, device=device), d=int(d),
                 signed=signed, seed=int(seed))


def accumulate_coords(sk: CSVec, idx: torch.Tensor,
                      vals: torch.Tensor) -> CSVec:
    """Sparse accumulate, in place: add vals[j] at coordinates idx[j]."""
    bk, sg = row_buckets_signs(sk.coeffs, idx, sk.cols, sk.signed)
    upd = sg * vals.to(torch.float32)[None, :]
    sk.table.scatter_add_(1, bk.to(torch.int64), upd)
    return sk


def query(sk: CSVec, idx: torch.Tensor) -> torch.Tensor:
    """Count-min point estimates at idx: the min over rows."""
    bk, sg = row_buckets_signs(sk.coeffs, idx, sk.cols, sk.signed)
    est = torch.gather(sk.table, 1, bk.to(torch.int64)) * sg
    return est.min(dim=0).values


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
