"""Plain PyTorch versions of the port's kernels.

``paged_attention_ref`` follows ``repro/kernels/ref.py:
paged_attention_ref`` op for op: a loop over the slot's logical blocks,
each physical block fetched through the table (dead entries >= NB clamp
the fetch and mask the whole block), f32 scores with ``-1e30`` as mask
and initial value, ``p`` re-zeroed after ``exp``, and ``p`` cast to the
value dtype before the weighted-value product.  It is what the CPU runs,
and what ``chip_smoke.py`` holds the CUDA kernel against on the card.
"""
from __future__ import annotations

import math

import torch


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
