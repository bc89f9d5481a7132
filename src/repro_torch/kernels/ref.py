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
``sketch_apply_ref`` is the fused form's plain version: the two halves,
then ``sketched_leaf_update`` (the AdamW step of one param piece from its
estimates, the sketched optimizer's math) piece by piece.

``tail_fold_ref`` and ``tail_scores_ref`` are the sketched-KV tail fold
and score estimates of ``repro/kernels/ref.py:kv_tail_fold_ref`` /
``kv_tail_scores_ref``, batched over a leading axis as the CUDA kernels
take them: the fold is the signed bucket-accumulate of
``serve/kv_sketch.py:fold_rows`` (one ``index_add_`` of the rows into a
zero delta, then the delta added to the tables), the scores the bucket
products gathered through the signed position hashes and combined with
``median_rows``.

``tail_fold_rowwise_ref`` is the fold done row by row in increasing n, each
table element receiving its additions one at a time, as the CUDA kernel
adds them: the kernel equals it bitwise.

``count_sketch_ref`` and ``unsketch_ref`` are ``repro/kernels/ref.py:
count_sketch_ref`` / ``unsketch_ref`` over D stacked hash rows, as the
CUDA kernels take them: the count sketch is one ``index_add_`` of the
signed rows per repetition, accumulated in f32 (as the TPU kernel
accumulates), the decompress one signed gather.

``count_sketch_tiled_ref`` is the count sketch in the CUDA kernel's order
of additions (chunks of I from ``kernels/count_sketch.py:plan``, tiles of
``TILE`` entries, each bucket's entries of a tile summed in order and
added once): the kernel equals it bitwise.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import torch

from repro_torch.sketch.csvec import (CSVec, accumulate_coords, median_rows,
                                     query)
from repro_torch.sketch.hashing import row_buckets_signs

__all__ = ["count_sketch_ref", "count_sketch_tiled_ref",
           "paged_attention_ref", "median_rows",
           "sketch_accumulate_ref", "sketch_apply_ref",
           "sketch_retrieve_ref", "sketched_leaf_update",
           "sketch_update_ref", "tail_fold_ref", "tail_fold_rowwise_ref",
           "tail_scores_ref", "unsketch_ref"]


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


def piece_layout(piece) -> Tuple[torch.Tensor, int, int, int]:
    """(flat g, offset, row, stride) of a sketch piece.  ``(g, offset)``
    is contiguous: element j of g is coordinate offset + j (row 0).
    ``(g, offset, row, stride)`` is strided: element j is coordinate
    offset + (j // row) * stride + j % row, rows of ``row`` elements
    ``stride`` apart (a parameter's local block when one of its dims is
    split across ranks); a piece of one row, or of row 0, is contiguous
    (row 0 is how the kernels mark one)."""
    g, offset, *rs = piece
    g = g.reshape(-1)
    if not rs or int(rs[0]) in (0, g.numel()):
        return g, int(offset), 0, 0
    row, stride = int(rs[0]), int(rs[1])
    if row < 1 or stride < row or g.numel() % row:
        raise ValueError(f"strided piece of {g.numel()} elements: row "
                         f"{row}, stride {stride}")
    return g, int(offset), row, stride


def piece_coords(n: int, offset: int, row: int, stride: int,
                 device) -> torch.Tensor:
    """The int64 coordinates of a piece's n elements (``piece_layout``)."""
    j = torch.arange(n, dtype=torch.int64, device=device)
    if row == 0:
        return offset + j
    return offset + torch.div(j, row, rounding_mode="floor") * stride \
        + j % row


def sketch_accumulate_ref(pieces: Iterable[tuple],
                          m_table: torch.Tensor, v_table: torch.Tensor,
                          coeffs_m: torch.Tensor, coeffs_v: torch.Tensor,
                          b1: float, b2: float):
    """New (R, C) moment tables after one step, functional:

      new_m = b1 * m_table + (1-b1) * CS(g)        (signed)
      new_v = b2 * v_table + (1-b2) * CMS(g^2)     (unsigned)

    where g is the flat vector whose pieces are ``(g_piece, offset)`` or
    strided ``(g_piece, offset, row, stride)`` (``piece_layout``); each
    piece is accumulated in f32."""
    cs_g = CSVec(table=torch.zeros_like(m_table), coeffs=coeffs_m, d=0,
                 signed=True)
    cs_g2 = CSVec(table=torch.zeros_like(v_table), coeffs=coeffs_v, d=0,
                  signed=False)
    for piece in pieces:
        g, offset, row, stride = piece_layout(piece)
        gf = g.to(torch.float32)
        idx = piece_coords(gf.numel(), offset, row, stride, gf.device)
        accumulate_coords(cs_g, idx, gf)
        accumulate_coords(cs_g2, idx, gf * gf)
    new_m = b1 * m_table + (1.0 - b1) * cs_g.table
    new_v = b2 * v_table + (1.0 - b2) * cs_g2.table
    return new_m, new_v


def sketch_retrieve_ref(n: int, offset: int, m_table: torch.Tensor,
                        v_table: torch.Tensor, coeffs_m: torch.Tensor,
                        coeffs_v: torch.Tensor, row: int = 0,
                        stride: int = 0):
    """(m_hat, v_hat) f32 at the coordinates of a piece of n elements at
    ``offset`` ([offset, offset + n), or strided rows: ``piece_layout``):
    the median-of-rows estimate of the signed table and the min-of-rows
    estimate of the count-min table."""
    idx = piece_coords(n, offset, row, stride, m_table.device)
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


def sketched_leaf_update(p: torch.Tensor, m_hat: torch.Tensor,
                         v_hat: torch.Tensor, *, lr: float, eps: float,
                         weight_decay: float, bc1: float,
                         bc2: float) -> None:
    """The AdamW step of one param (piece) from its moment estimates,
    in place on p (the sketched optimizer's math)."""
    mh = (m_hat / bc1).reshape(p.shape)
    vh = (torch.clamp(v_hat, min=0.0) / bc2).reshape(p.shape)
    delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
    del mh, vh
    p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))


def sketch_step_ref(pieces: Iterable[tuple], params: Iterable[torch.Tensor],
                    m_table: torch.Tensor, v_table: torch.Tensor,
                    coeffs_m: torch.Tensor, coeffs_v: torch.Tensor, *,
                    lr: float, eps: float, weight_decay: float, bc1: float,
                    bc2: float) -> None:
    """The AdamW step of each param piece from the tables as they are, in
    place: per piece ``sketch_retrieve_ref`` and ``sketched_leaf_update``
    (each piece's estimates freed before the next's are made)."""
    for p, piece in zip(params, pieces):
        g, off, row, stride = piece_layout(piece)
        m_hat, v_hat = sketch_retrieve_ref(g.numel(), off, m_table, v_table,
                                           coeffs_m, coeffs_v, row, stride)
        sketched_leaf_update(p, m_hat, v_hat, lr=lr, eps=eps,
                             weight_decay=weight_decay, bc1=bc1, bc2=bc2)
        del m_hat, v_hat


def sketch_apply_ref(pieces: Iterable[tuple],
                     params: Iterable[torch.Tensor], m_table: torch.Tensor,
                     v_table: torch.Tensor, coeffs_m: torch.Tensor,
                     coeffs_v: torch.Tensor, *, b1: float, b2: float,
                     lr: float, eps: float, weight_decay: float, bc1: float,
                     bc2: float) -> None:
    """The fused form's plain version, in place on the tables and params:
    ``sketch_accumulate_ref``, then ``sketch_step_ref``."""
    pieces = list(pieces)
    new_m, new_v = sketch_accumulate_ref(pieces, m_table, v_table, coeffs_m,
                                         coeffs_v, b1, b2)
    m_table.copy_(new_m)
    v_table.copy_(new_v)
    del new_m, new_v
    sketch_step_ref(pieces, params, m_table, v_table, coeffs_m, coeffs_v,
                    lr=lr, eps=eps, weight_decay=weight_decay, bc1=bc1,
                    bc2=bc2)


def tail_fold_ref(rows: torch.Tensor, positions: torch.Tensor,
                  counts: torch.Tensor, tail: torch.Tensor,
                  coeffs: torch.Tensor, col0: int = 0,
                  cols: Optional[int] = None) -> torch.Tensor:
    """In place: ``tail[g, z, h_z(p)] += s_z(p) * rows[g, n]`` for the
    first ``counts[g]`` rows n of each batch element, p = positions[g, n].
    rows (G, N, D); positions (G, N) int; counts (G,) int; tail
    (G, Z, Cl, D) f32 (may be a strided view) holding bucket columns
    [col0, col0 + Cl) of ``cols`` (default: all of them), the rows hashed
    against ``cols`` and those landing outside the range dropped, so a
    column shard's fold is bitwise its columns of the whole one (each
    kept term is added in the same order); coeffs (Z, 4) int64.
    Returns ``tail``."""
    G, N, D = rows.shape
    _, Z, C, _ = tail.shape
    cols = C if cols is None else int(cols)
    bk, sg = row_buckets_signs(coeffs, positions.reshape(-1), cols,
                               signed=True)                    # (Z, G*N)
    valid = (torch.arange(N, device=rows.device)[None, :]
             < counts.to(rows.device)[:, None]).reshape(1, G * N)
    sg = torch.where(valid, sg, torch.zeros_like(sg))
    g = torch.arange(G, device=rows.device).repeat_interleave(N)
    z = torch.arange(Z, device=rows.device)[:, None]
    local = bk.long() - int(col0)
    keep = ((local >= 0) & (local < C)).reshape(-1)
    flat = ((g[None, :] * Z + z) * C + local).reshape(-1)       # (Z*G*N,)
    vals = (sg[:, :, None] * rows.reshape(1, G * N, D).float()).reshape(
        -1, D)
    if C != cols:
        flat, vals = flat[keep], vals[keep]
    delta = torch.zeros((G * Z * C, D), dtype=torch.float32,
                        device=rows.device)
    delta.index_add_(0, flat, vals)
    tail.add_(delta.view(G, Z, C, D))
    return tail


def tail_fold_rowwise_ref(rows: torch.Tensor, positions: torch.Tensor,
                          counts: torch.Tensor, tail: torch.Tensor,
                          coeffs: torch.Tensor) -> torch.Tensor:
    """``tail_fold_ref`` row by row: for n = 0, 1, ... every table that
    row n of its batch element reaches gets ``+= s_z(p) * row`` in f32,
    one addition per element (no two (g, z) tables share an element, so
    each step is one indexed update).  In place; returns ``tail``."""
    G, N, D = rows.shape
    _, Z, C, _ = tail.shape
    bk, sg = row_buckets_signs(coeffs, positions.reshape(-1), C,
                               signed=True)
    bk, sg = bk.reshape(Z, G, N).long(), sg.reshape(Z, G, N)
    z = torch.arange(Z, device=tail.device)[None, :]
    for n in range(N):
        g = torch.nonzero(n < counts.to(tail.device))[:, 0]
        if g.numel() == 0:
            break
        x = rows[g, n].float()[:, None, :]                   # (Gn, 1, D)
        neg = (sg[:, g, n] < 0).T[..., None]                 # (Gn, Z, 1)
        idx = (g[:, None], z, bk[:, g, n].T)
        tail[idx] = tail[idx] + torch.where(neg, -x, x)
    return tail


def tail_scores_ref(q: torch.Tensor, tail_k: torch.Tensor,
                    coeffs: torch.Tensor, T: int) -> torch.Tensor:
    """Median-of-rows score estimates ``out[b, k, n, t] = median_z
    s_z(t) * q[b, k, n] . tail_k[b, z, h_z(t), k]`` for t in [0, T).
    q (B, K, N, hd) f32; tail_k (B, Z, C, K, hd) f32 -> (B, K, N, T):
    ``tail_select_ref`` of ``tail_products_ref``."""
    return tail_select_ref(tail_products_ref(q, tail_k), coeffs, T)


def tail_products_ref(q: torch.Tensor, tail_k: torch.Tensor
                      ) -> torch.Tensor:
    """The bucket products ``P[b, k, z, n, c] = q[b, k, n] . tail_k[b, z,
    c, k]``: q (B, K, N, hd); tail_k (B, Z, C, K, hd), all C columns or a
    column shard -> (B, K, Z, N, C) f32.  One (N, hd) x (hd, C) product
    a (b, k, z); each column's sum over hd does not depend on the others,
    so a shard's products are bitwise its columns of the whole ones."""
    tk = tail_k.float().permute(0, 3, 1, 4, 2)                # (B,K,Z,hd,C)
    return torch.matmul(q.float()[:, :, None], tk)


def tail_select_ref(prod: torch.Tensor, coeffs: torch.Tensor,
                    T: int) -> torch.Tensor:
    """Median-of-rows estimates (B, K, N, T) from the products (B, K, Z,
    N, C) of all C columns: ``median_z s_z(t) * P[b, k, z, n, h_z(t)]``."""
    C = prod.shape[-1]
    bk, sg = row_buckets_signs(
        coeffs, torch.arange(T, dtype=torch.int64, device=prod.device), C,
        signed=True)                                            # (Z, T)
    est = torch.stack([prod[:, :, z][..., bk[z].long()] * sg[z]
                       for z in range(prod.shape[2])])          # (Z,B,K,N,T)
    return median_rows(est)


def count_sketch_ref(x: torch.Tensor, h: torch.Tensor, s: torch.Tensor,
                     J: int) -> torch.Tensor:
    """x (B, I); h, s (D, I) or (I,) with 0 <= h < J -> (D, B, J), or
    (B, J) for 1-D tables, in x's type: ``out[d, b, j] = sum_{h_d(i) = j}
    s_d(i) x[b, i]``, accumulated in f32."""
    h2, s2 = h.reshape(-1, h.shape[-1]), s.reshape(-1, s.shape[-1])
    xf = x.to(torch.float32)
    out = torch.zeros((h2.shape[0], x.shape[0], int(J)), dtype=torch.float32,
                      device=x.device)
    for d in range(h2.shape[0]):
        out[d].index_add_(1, h2[d].long(), xf * s2[d].to(torch.float32))
    out = out.to(x.dtype)
    return out[0] if h.ndim == 1 else out


def count_sketch_tiled_ref(x: torch.Tensor, h: torch.Tensor,
                           s: torch.Tensor, J: int,
                           chunks: Optional[int] = None) -> torch.Tensor:
    """``count_sketch_ref`` summed as the CUDA kernel sums: each chunk of
    ``plan``'s split of I from zero and its tiles in order; within a tile
    each bucket's entries summed in increasing i and the sum added to the
    bucket once.  The chunks' partials are then added in increasing
    order."""
    from repro_torch.kernels.count_sketch import TILE, plan
    h2, s2 = h.reshape(-1, h.shape[-1]), s.reshape(-1, s.shape[-1])
    D, I = h2.shape
    B, J = x.shape[0], int(J)
    v = x.to(torch.float32)[None] * s2[:, None, :]               # (D, B, I)
    tiles = max(1, -(-I // TILE))
    per = plan(D, max(B, 1), I, J, x.element_size(),
               chunks).tiles_per_chunk
    out = None
    for t0 in range(0, tiles, per):
        acc = torch.zeros((D, B, J), dtype=torch.float32, device=x.device)
        for t in range(t0, min(tiles, t0 + per)):
            lo, hi = t * TILE, min(I, (t + 1) * TILE)
            for d in range(D):
                hv = h2[d, lo:hi].long()
                ok = (hv >= 0) & (hv < J)
                # the k-th entry of each bucket in the tile, k = 0, 1, ...
                same = hv[:, None] == hv[None, :]
                k = torch.tril(same, diagonal=-1).sum(1)
                tile_sum = torch.zeros((B, J), dtype=torch.float32,
                                       device=x.device)
                for kk in range(int(k[ok].max()) + 1 if bool(ok.any()) else 0):
                    sel = ok & (k == kk)
                    tile_sum.index_add_(1, hv[sel], v[d][:, lo:hi][:, sel])
                acc[d] += tile_sum
        out = acc if out is None else out + acc
    out = out.to(x.dtype)
    return out[0] if h.ndim == 1 else out


def unsketch_ref(y: torch.Tensor, h: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """y (B, J) shared by every repetition, or (D, B, J); h, s (D, I) or
    (I,) -> (D, B, I), or (B, I) for 1-D tables and a 2-D y, in y's type:
    ``out[d, b, i] = y[d, b, h_d(i)] * s_d(i)``."""
    h2, s2 = h.reshape(-1, h.shape[-1]), s.reshape(-1, s.shape[-1])
    D, I = h2.shape
    y3 = y.expand(D, *y.shape) if y.ndim == 2 else y
    idx = h2.long()[:, None, :].expand(D, y3.shape[1], I)
    out = torch.gather(y3, 2, idx) * s2[:, None, :].to(y.dtype)
    return out[0] if h.ndim == 1 and y.ndim == 2 else out
