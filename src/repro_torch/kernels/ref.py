"""Plain PyTorch versions of the port's kernels.

``paged_attention_ref`` follows ``repro/kernels/ref.py:
paged_attention_ref`` op for op: a loop over the slot's logical blocks,
each physical block fetched through the table (dead entries >= NB clamp
the fetch and mask the whole block), f32 scores with ``-1e30`` as mask
and initial value, ``p`` re-zeroed after ``exp``, and ``p`` cast to the
value dtype before the weighted-value product.  It is what the CPU runs,
and what ``chip_smoke.py`` holds the CUDA kernel against on the card.

``sketch_update_ref`` follows ``repro/kernels/ref.py:sketch_update_ref``:
the sketched-AdamW moment update and retrieve written through the signed
and count-min ``CSVec`` (sketch/csvec.py), whose median is the plain
``median_rows``.  ``sketch_accumulate_ref`` and ``sketch_retrieve_ref``
are its two halves over the pieces of one flat vector (element j of a
piece at ``offset`` is coordinate ``offset + j``); they are what
``kernels/ops.py:sketch_update_op`` runs on CPU tensors.
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple

import torch

from repro_torch.sketch.csvec import CSVec, accumulate, median_rows, query

__all__ = ["paged_attention_ref", "median_rows", "sketch_accumulate_ref",
           "sketch_retrieve_ref", "sketch_update_ref"]


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, tables: torch.Tensor,
                        start: torch.Tensor, fold_base: torch.Tensor):
    """q (B,Sq,K,R,hd); pools (NB,bs,K,hd); tables (B,nb) int32;
    start/fold_base (B,) int32 -> f32 (m, l, acc): (B,K,R,Sq) x2 and
    (B,K,R,Sq,hd).  Query row i of slot b sees key position p iff
    ``fold_base[b] <= p <= start[b] + i`` and p's block is live."""
    B, Sq, K, R, hd = q.shape
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    nb_slot = tables.shape[1]
    NQ = R * Sq
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    qt = q.permute(0, 2, 3, 1, 4).reshape(B, K, NQ, hd).float()
    st = start.to(torch.int32)
    fb = fold_base.to(torch.int32)
    qi = (torch.arange(NQ, device=dev, dtype=torch.int32) % Sq)[:, None]
    m = torch.full((B, K, NQ), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, NQ), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, NQ, hd), dtype=torch.float32, device=dev)
    for j in range(nb_slot):
        entry = tables[:, j]
        valid = entry < NB
        phys = torch.clamp(entry, max=NB - 1).long()
        kj, vj = k_pool[phys], v_pool[phys]              # (B, bs, K, hd)
        kpos = j * bs + torch.arange(bs, device=dev, dtype=torch.int32)
        live = ((kpos[None, None, :] <= st[:, None, None] + qi[None])
                & (kpos[None, None, :] >= fb[:, None, None])
                & valid[:, None, None])                  # (B, NQ, bs)
        live = live[:, None]                             # (B, 1, NQ, bs)
        # bf16 x bf16 products are exact in f32, so the f32 einsum is the
        # reference's bf16 dot with f32 accumulation
        s = torch.einsum("bknh,bskh->bkns", qt, kj.float()) * scale
        s = torch.where(live, s, torch.full_like(s, -1e30))
        m_cur = torch.maximum(m, s.max(dim=-1).values)
        p = torch.where(live, torch.exp(s - m_cur[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_cur)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkns,bskh->bknh", p.to(vj.dtype).float(),
                          vj.float())
        acc = acc * corr[..., None] + pv
        m = m_cur
    return (m.reshape(B, K, R, Sq), l.reshape(B, K, R, Sq),
            acc.reshape(B, K, R, Sq, hd))


def sketch_accumulate_ref(pieces: Iterable[Tuple[torch.Tensor, int]],
                          m_table: torch.Tensor, v_table: torch.Tensor,
                          coeffs_m: torch.Tensor, coeffs_v: torch.Tensor,
                          b1: float, b2: float):
    """New (R, C) moment tables after one step, functional:

      new_m = b1 * m_table + (1-b1) * CS(g)        (signed)
      new_v = b2 * v_table + (1-b2) * CMS(g^2)     (unsigned)

    where g is the flat vector whose pieces are ``(g_piece, offset)``;
    each piece is accumulated in f32."""
    cs_g = CSVec(table=torch.zeros_like(m_table), coeffs=coeffs_m, d=0,
                 signed=True)
    cs_g2 = CSVec(table=torch.zeros_like(v_table), coeffs=coeffs_v, d=0,
                  signed=False)
    for g, offset in pieces:
        gf = g.reshape(-1).to(torch.float32)
        accumulate(cs_g, gf, offset)
        accumulate(cs_g2, gf * gf, offset)
    new_m = b1 * m_table + (1.0 - b1) * cs_g.table
    new_v = b2 * v_table + (1.0 - b2) * cs_g2.table
    return new_m, new_v


def sketch_retrieve_ref(n: int, offset: int, m_table: torch.Tensor,
                        v_table: torch.Tensor, coeffs_m: torch.Tensor,
                        coeffs_v: torch.Tensor):
    """(m_hat, v_hat) f32 at coordinates [offset, offset + n): the
    median-of-rows estimate of the signed table and the min-of-rows
    estimate of the count-min table."""
    idx = offset + torch.arange(n, dtype=torch.int64,
                                device=m_table.device)
    m_hat = query(CSVec(table=m_table, coeffs=coeffs_m, d=0, signed=True),
                  idx)
    v_hat = query(CSVec(table=v_table, coeffs=coeffs_v, d=0, signed=False),
                  idx)
    return m_hat, v_hat


def sketch_update_ref(g: torch.Tensor, m_table: torch.Tensor,
                      v_table: torch.Tensor, coeffs_m: torch.Tensor,
                      coeffs_v: torch.Tensor, b1: float, b2: float,
                      offset: int = 0):
    """Fused optimizer update-retrieve on sketched (m, v) moments for one
    flat piece.  g: (n,) any float dtype; tables (R, C) f32; coeffs
    (R, 4) uint32 values (int64).  Returns (new_m, new_v, m_hat, v_hat)
    and leaves the given tables unchanged."""
    new_m, new_v = sketch_accumulate_ref([(g, offset)], m_table, v_table,
                                         coeffs_m, coeffs_v, b1, b2)
    m_hat, v_hat = sketch_retrieve_ref(g.numel(), offset, new_m, new_v,
                                       coeffs_m, coeffs_v)
    return new_m, new_v, m_hat, v_hat
