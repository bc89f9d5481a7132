"""Sketched long-context KV (port of ``repro/serve/kv_sketch.py``):
per-slot, per-layer FCS tail tables.

When a KV block ages past the slot's exact window
(``ServeConfig.kv_sketch_window``), its key and value rows are
count-sketched along the sequence axis into per-slot, per-layer
(rows Z, cols C, K, hd) f32 tail tables and the block returns to the
pool.  Decode attention becomes two-span: exact paged attention over
[fold_base, pos] and sketched attention over the folded span
[0, fold_base), merged with online-softmax statistics; slots with
``fold_base == 0`` keep the exact output verbatim (models/layers.py).

Layout.  The reference keeps {"k", "v"} leaves of (L, B, Z, C, K, hd);
the port stacks them into one (2, L, B, Z, C, K, hd) tensor (index 0 is
k, 1 is v), so one fold launch covers every layer, slot and both tables.
Tables are updated in place.

On the card the fold (``fold_pool``) gathers the aged rows from the pool
and calls ``kernels/ops.py:tail_fold_op``; the tail span's score
estimates (``tail_attend``) come from ``tail_scores_op``.  The live mask,
the softmax over positions, the count sketch of the softmax weights, the
value contraction and its median over rows stay plain PyTorch, as in the
reference.  On CPU tensors both ops run their plain versions.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.count_sketch import Index, bucket_links
from repro_torch.models.layers import padded_rows, slab_rows
from repro_torch.sketch.csvec import median_rows
from repro_torch.sketch.hashing import cached_coeffs, row_buckets_signs

# tail-table hash seeds derive from the serve seed but never collide with
# the prefix cache's count-min seed (same hashing family)
_SEED_SALT = 0x4B56AD


def tail_seed(sv: ServeConfig) -> int:
    return (int(sv.seed) ^ _SEED_SALT) & 0x7FFFFFFF


def tail_coeffs(sv: ServeConfig, device=None) -> torch.Tensor:
    """(rows, 4) uint32 hash coefficients (as int64) for the tail
    tables."""
    return cached_coeffs(tail_seed(sv), sv.kv_sketch_rows, device=device)


def tail_cols(max_seq: int, ratio: int) -> int:
    """Tail-table columns: ~max_seq / ratio, rounded up to a multiple of
    16, at least 16."""
    c = -(-max_seq // max(1, ratio))
    return max(16, -(-c // 16) * 16)


def pos_domain(max_seq: int, block_size: int) -> int:
    """Hashed position domain T: every foldable absolute position lives
    in [0, T) — whole blocks only, so round max_seq up to blocks."""
    return -(-max_seq // block_size) * block_size


class PosHash(NamedTuple):
    bk: torch.Tensor        # (Z, T) int32 buckets
    sg: torch.Tensor        # (Z, T) f32 signs
    links: Index            # their bucket links (count_sketch's order)


def pos_buckets_signs(coeffs: torch.Tensor, T: int, cols: int) -> PosHash:
    """(Z, T) buckets and signs of positions [0, T), with their bucket
    links: the hashes fold and query share, computed once per engine (the
    port's form of the reference's precomputed ``pos_onehot``)."""
    idx = torch.arange(T, dtype=torch.int64, device=coeffs.device)
    bk, sg = row_buckets_signs(coeffs, idx, cols, signed=True)
    return PosHash(bk, sg, bucket_links(bk, sg, cols))


def pos_onehot(coeffs: torch.Tensor, T: int, cols: int) -> torch.Tensor:
    """(Z, T, cols) signed position one-hot: onehot[z, j, c] =
    s_z(j) * [h_z(j) == c] (the reference's fold and query operand; the
    port count-sketches through ``pos_buckets_signs`` instead)."""
    bk, sg, _ = pos_buckets_signs(coeffs, T, cols)
    cols_iota = torch.arange(cols, dtype=torch.int64, device=coeffs.device)
    return torch.where(cols_iota[None, None, :] == bk[:, :, None],
                       sg[:, :, None], torch.zeros((), device=coeffs.device))


def init_tail(cfg: ModelConfig, batch: int, rows: int, cols: int,
              device=None) -> torch.Tensor:
    """Per-slot, per-layer tail tables, k and v stacked:
    (2, L, B, rows, cols, K, hd) f32 zeros."""
    return torch.zeros((2, cfg.num_layers, batch, rows, cols,
                        cfg.num_kv_heads, cfg.resolved_head_dim),
                       dtype=torch.float32, device=device)


def tail_state_bytes(tail: torch.Tensor) -> int:
    return tail.numel() * tail.element_size()


# ---------------------------------------------------------------------------
# Fold: pool blocks -> tail tables
# ---------------------------------------------------------------------------


def fold_pool(pool: Dict[str, torch.Tensor], tail: torch.Tensor,
              tables: torch.Tensor, fold_from: torch.Tensor,
              fold_len: torch.Tensor, coeffs: torch.Tensor, fold_cap: int,
              use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Fold each slot's next ``fold_len[b]`` aged KV rows into its tail,
    in place.

    pool: {"k","v"} (L, NB + 1, bs, K, hd) — the paged pool with its
    write sink; the rows being folded are still table-mapped.  tail:
    (2, L, B, Z, C, K, hd), or one slot's (2, L, 1, Z, C, K, hd) view.
    tables: (B, blocks_per_slot) int32.  fold_from: (B,) first absolute
    position to fold (block-aligned).  fold_len: (B,) rows to fold, at
    most ``fold_cap``.  Rows past ``fold_len`` are gathered (from a
    clamped block) but add nothing.  Returns ``tail``."""
    F = int(fold_cap)
    if F == 0:
        return tail
    L, NB1, bs = pool["k"].shape[0], pool["k"].shape[1], pool["k"].shape[2]
    NB = NB1 - 1
    B, nb = tables.shape
    dev = tables.device
    p = fold_from.to(torch.int32)[:, None] + torch.arange(
        F, dtype=torch.int32, device=dev)[None, :]               # (B, F)
    blk = torch.clamp(torch.div(p, bs, rounding_mode="floor"), 0, nb - 1)
    phys = torch.clamp(torch.gather(tables, 1, blk.long()), 0, NB - 1).long()
    off = (p % bs).long()
    rows = torch.stack([pool["k"][:, phys, off], pool["v"][:, phys, off]])
    Z, C, K, hd = tail.shape[3:]
    G = 2 * L * B
    kops.tail_fold_op(
        rows.reshape(G, F, K * hd),
        p.expand(2 * L, B, F).reshape(G, F).contiguous(),
        fold_len.to(torch.int32).expand(2 * L, B).reshape(G).contiguous(),
        tail.view(G, Z, C, K * hd), coeffs, use_kernel=use_kernel)
    return tail


def fold_rows(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
              coeffs: torch.Tensor, cols: int) -> torch.Tensor:
    """Fold of explicit rows (no pool or tables): k/v (B, n, K, hd) at
    absolute ``positions`` (n,) -> tail (2, B, Z, cols, K, hd) f32."""
    B, n, K, hd = k.shape
    Z = coeffs.shape[0]
    tail = torch.zeros((2, B, Z, cols, K, hd), dtype=torch.float32,
                       device=k.device)
    rows = torch.stack([k, v]).reshape(2 * B, n, K * hd)
    kops.tail_fold_op(
        rows, positions.to(torch.int32).expand(2 * B, n).contiguous(),
        torch.full((2 * B,), n, dtype=torch.int32, device=k.device),
        tail.view(2 * B, Z, cols, K * hd), coeffs)
    return tail


# ---------------------------------------------------------------------------
# Query: online-softmax statistics of the sketched tail span
# ---------------------------------------------------------------------------


def tail_attend(q: torch.Tensor, tail_k: torch.Tensor, tail_v: torch.Tensor,
                coeffs: torch.Tensor,
                pos_hash: PosHash,
                fold_base: torch.Tensor, scale: float,
                use_kernel: Optional[bool] = None,
                slab: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Approximate attention statistics over the folded span [0, fold_base).

    q: (B, Sq, K, R, hd) queries; tail_k/tail_v: (B, Z, C, K, hd) f32 (one
    layer's tables); pos_hash: ``pos_buckets_signs`` over the position
    domain T (``pos_domain``); fold_base: (B,) int32.  Every query
    position is >= fold_base, so the whole tail is causally visible —
    only the live-span mask applies.

    A query row's statistics are the same bits whatever Sq the call has:
    the score estimates and the softmax reduce each row alone, the count
    sketch of the softmax weights runs in one chunk of positions
    (``count_sketch_op(chunks=1)``, a fixed order of additions), and the
    value contraction runs at ``padded_rows(R*Sq)`` rows or, with
    ``slab`` (the decode and verify steps: ``padded_rows(R)``, a decode
    step's), over the R*Sq rows padded to whole slabs, one slab at a
    time, so a verify step's rows are its decode steps' at any spec_k.

    Returns (m, l, acc): (B, K, R, Sq), same, and (B, K, R, Sq, hd) f32,
    merge-ready against the exact span's statistics.  An empty tail
    (fold_base == 0) yields m = -1e30, l = 0, acc = 0."""
    B, Sq, K, R, hd = q.shape
    Z, C = tail_k.shape[1], tail_k.shape[2]
    bk, sg, links = pos_hash                                  # (Z, T)
    T = bk.shape[1]
    qt = q.permute(0, 2, 3, 1, 4).reshape(B, K, R * Sq, hd).float()
    est = kops.tail_scores_op(qt.contiguous(), tail_k, coeffs, T,
                              use_kernel=use_kernel)     # (B, K, R*Sq, T)
    s = est.view(B, K, R, Sq, T) * scale
    live = (torch.arange(T, device=q.device)[None, :]
            < fold_base[:, None])[:, None, None, None, :]     # (B,1,1,1,T)
    s = torch.where(live, s, -1e30)
    m = s.max(dim=-1).values                                  # (B,K,R,Sq)
    w = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = w.sum(dim=-1)
    # CS is linear: sum_j w_j v_j ~= < CS_z(w), tail_v[z] > per row z
    RS = R * Sq
    cw = kops.count_sketch_op(w.reshape(B * K * RS, T), bk, sg, C,
                              index=links, use_kernel=use_kernel, chunks=1)
    rows = padded_rows(RS) if slab is None else slab_rows(RS, slab)
    cw = F.pad(cw.view(Z, B, K, RS, C).permute(1, 0, 2, 3, 4),
               (0, 0, 0, rows - RS))                         # (B,Z,K,rows,C)
    tv = tail_v.float().permute(0, 1, 3, 2, 4)
    if slab is None or rows == slab:
        est_v = torch.matmul(cw, tv)
    else:
        est_v = torch.cat([torch.matmul(c.contiguous(), tv)
                           for c in cw.split(slab, dim=3)], dim=3)
    acc = median_rows(est_v[:, :, :, :RS].permute(1, 0, 2, 3, 4))
    return m, l, acc.reshape(B, K, R, Sq, hd)


def merge_spans(m_e: torch.Tensor, l_e: torch.Tensor, acc_e: torch.Tensor,
                m_t: torch.Tensor, l_t: torch.Tensor, acc_t: torch.Tensor
                ) -> torch.Tensor:
    """Online-softmax merge of exact-window and sketch-tail statistics.
    All f32; shapes (B,K,R,Sq) / (B,K,R,Sq,hd).  Returns (B,K,R,Sq,hd).
    The exact span always holds the query's own position, so the
    denominator is positive."""
    m = torch.maximum(m_e, m_t)
    a_e = torch.exp(m_e - m)
    a_t = torch.exp(m_t - m)
    num = acc_e * a_e[..., None] + acc_t * a_t[..., None]
    den = l_e * a_e + l_t * a_t
    return num / torch.clamp(den, min=1e-30)[..., None]


def exact_span_stats(s: torch.Tensor, v: torch.Tensor, live: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 online-softmax statistics of an exact masked score tensor.
    s: (B, K, R, Sq, Sk) with dead positions at -1e30; ``live`` the bool
    mask that produced them; v: (B, Sk, K, hd).  Returns (m, l, acc) as
    ``tail_attend``."""
    m = s.max(dim=-1).values
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkrqs,bskh->bkrqh", p, v.float())
    return m, l, acc


# ---------------------------------------------------------------------------
# Dense oracle (tests)
# ---------------------------------------------------------------------------


def dense_tail_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     fold_base: torch.Tensor, scale: float):
    """Exact (m, l, acc) over the folded span — what ``tail_attend``
    approximates.  k/v: (B, T, K, hd), the true rows at positions
    [0, T)."""
    s = torch.einsum("bqkrh,bskh->bkrqs", q.float(), k.float()) * scale
    T = k.shape[1]
    live = (torch.arange(T, device=q.device)[None, :]
            < fold_base[:, None])[:, None, None, None, :]
    s = torch.where(live, s, torch.full_like(s, -1e30))
    return exact_span_stats(s, v, live)


# ---------------------------------------------------------------------------
# Fidelity probe: per-row estimate spread (sampled by the observer at
# ``SlotScheduler.collect``, ``_probe_fidelity``)
# ---------------------------------------------------------------------------


def tail_row_spread(tail: torch.Tensor) -> torch.Tensor:
    """Per-slot relative spread of the Z hash rows' tail energy: each row
    is an independent count sketch of the same folded rows, so its energy
    e_z = sum over (L, C, K, hd) of tail_k^2 + tail_v^2 differs from the
    others only through collisions.  tail: (2, L, B, Z, C, K, hd).
    Returns (B,) f32: (max_z e - min_z e) / median_z e, 0 for an empty
    tail."""
    e = tail.square().sum(dim=(0, 1, 4, 5, 6))                 # (B, Z)
    med = median_rows(e.t())
    spread = e.max(dim=1).values - e.min(dim=1).values
    return torch.where(med > 0.0, spread / torch.clamp(med, min=1e-30),
                       torch.zeros_like(med))
