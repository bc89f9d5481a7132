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
from repro_torch.models.ranks import Collective, mesh_collect, run
from repro_torch.models.sharding import (current_rules, entry_axes,
                                         from_local, is_dtensor, norm_spec,
                                         placements, to_local, unwrap)
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
    clamped block) but add nothing.  Returns ``tail``.

    DTensor pool and tail (the sharded serve path, launch/shardings.py:
    the pool's block axis split over the batch and ``kv_blocks`` axes, or
    ``kv_blocks`` alone; the tail's slots over ``batch`` and its bucket
    columns over ``kv_blocks``): each rank runs ``fold_pool_rank`` for
    its slots, gathering each row being folded from the block shard that
    holds it and folding the rows into its own columns, bitwise those
    columns of the unsharded fold.  The tail must then be the whole
    stacked tensor, not a one-slot view."""
    F = int(fold_cap)
    if F == 0:
        return tail
    if is_dtensor(tail):
        return _fold_pool_sharded(pool, tail, tables, fold_from, fold_len,
                                  coeffs, F, use_kernel)
    # not solo(fold_pool_rank): with every block at hand the rows are read
    # straight from the pool, without the rank form's stack and owner pick
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


def fold_pool_rank(pool_k: torch.Tensor, pool_v: torch.Tensor, lo: int,
                   NB: int, tail: torch.Tensor, col0: int, cols: int,
                   tables: torch.Tensor, fold_from: torch.Tensor,
                   fold_len: torch.Tensor, coeffs: torch.Tensor,
                   fold_cap: int, use_kernel: Optional[bool] = None):
    """``fold_pool`` as one rank's body (models/ranks.py) on a pool split
    by blocks and a tail split by bucket columns.  pool_k / pool_v: this
    rank's (L, n, bs, K, hd) blocks [lo, lo + n) of the NB + 1; tail: its
    (2, L, B, Z, Cl, K, hd) tables, columns [col0, col0 + Cl) of ``cols``,
    of its B slots, whose tables / fold_from / fold_len rows these are.
    Each rank reads the rows being folded that lie in its blocks; the
    candidates and the masks of the rows each holds are gathered over
    the ranks that split the blocks (two "gather"s), every row is taken
    from the rank that holds it, bitwise, and the rows fold into this
    rank's columns (``tail_fold_op``'s column range).  Returns ``tail``."""
    F = int(fold_cap)
    L, n, bs = pool_k.shape[0], pool_k.shape[1], pool_k.shape[2]
    B, nb = tables.shape
    dev = tables.device
    p = fold_from.to(torch.int32)[:, None] + torch.arange(
        F, dtype=torch.int32, device=dev)[None, :]               # (B, F)
    blk = torch.clamp(torch.div(p, bs, rounding_mode="floor"), 0, nb - 1)
    phys = torch.clamp(torch.gather(tables.long(), 1, blk.long()), 0, NB - 1)
    held = (phys >= lo) & (phys < lo + n)
    at = (phys - lo).clamp(0, n - 1)
    off = (p % bs).long()
    cand = torch.stack([pool_k[:, at, off], pool_v[:, at, off]])
    cand = cand.permute(2, 0, 1, 3, 4, 5)[:, None]      # (B,1,2,L,F,K,hd)
    cand = yield Collective("gather", cand, dim=1)
    held = yield Collective("gather", held[:, None].to(torch.int32), dim=1)
    owner = held.argmax(dim=1)                                # (B, F)
    idx = owner[:, None, None, None, :, None, None].expand(
        (B, 1) + tuple(cand.shape[2:]))
    rows = torch.take_along_dim(cand, idx, dim=1)[:, 0]   # (B,2,L,F,K,hd)
    Z, Cl, K, hd = tail.shape[3:]
    G = 2 * L * B
    kops.tail_fold_op(
        rows.permute(1, 2, 0, 3, 4, 5).reshape(G, F, K * hd),
        p.expand(2 * L, B, F).reshape(G, F).contiguous(),
        fold_len.to(torch.int32).expand(2 * L, B).reshape(G).contiguous(),
        tail.view(G, Z, Cl, K * hd), coeffs, use_kernel=use_kernel,
        col0=col0, cols=cols)
    return tail


def _fold_pool_sharded(pool: Dict[str, torch.Tensor], tail: torch.Tensor,
                       tables: torch.Tensor, fold_from: torch.Tensor,
                       fold_len: torch.Tensor, coeffs: torch.Tensor,
                       F: int, use_kernel: Optional[bool]) -> torch.Tensor:
    """``fold_pool`` on a mesh of more than one device: one rank's
    ``fold_pool_rank`` with its collectives over the ``kv_blocks`` axes."""
    from repro_torch.models.layers import _local_range
    rules = current_rules() or {}
    mesh = tail.device_mesh
    b = rules.get("batch")
    kb = entry_axes(rules.get("kv_blocks"))
    spec = norm_spec((None, None, b, None, rules.get("kv_blocks"), None,
                      None))
    if tuple(tail.placements) != placements(spec, mesh):
        raise ValueError(f"the tail folds in place on its shards, placed "
                         f"as launch/shardings.py:_tail_spec places it "
                         f"({spec}), not {tuple(tail.placements)}")
    rs = norm_spec((b,))
    mine = lambda t: to_local(t if is_dtensor(t) else from_local(
        t, mesh, (None,) * t.ndim), rs + (None,) * (t.ndim - 1))
    lo, _ = _local_range(pool["k"], 1)
    col0, _ = _local_range(tail, 4)
    body = fold_pool_rank(pool["k"].to_local(), pool["v"].to_local(), lo,
                          pool["k"].shape[1] - 1, tail.to_local(), col0,
                          tail.shape[4], mine(tables), mine(fold_from),
                          mine(fold_len), unwrap(coeffs), F, use_kernel)
    run(body, mesh_collect(mesh, kb))
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
    (fold_base == 0) yields m = -1e30, l = 0, acc = 0.  On tables split
    by columns over ranks, ``tail_attend_rank``."""
    B, Sq, K, R, hd = q.shape
    T = pos_hash.bk.shape[1]
    # not solo(tail_attend_rank): with all C columns at hand the fused
    # tail_scores kernel keeps the products on chip, one launch
    est = kops.tail_scores_op(_query_rows(q), tail_k, coeffs, T,
                              use_kernel=use_kernel)     # (B, K, R*Sq, T)
    m, l, w = _tail_softmax(est, fold_base, scale, (B, K, R, Sq))
    est_v = _tail_values(w, pos_hash, tail_k.shape[2], tail_v, 0, (B, K, R,
                                                                  Sq),
                         use_kernel, slab)
    return m, l, _tail_median(est_v, (B, K, R, Sq, hd))


def tail_attend_rank(q: torch.Tensor, tail_k: torch.Tensor,
                     tail_v: torch.Tensor, coeffs: torch.Tensor,
                     pos_hash: PosHash, fold_base: torch.Tensor,
                     scale: float, col0: int,
                     use_kernel: Optional[bool] = None,
                     slab: Optional[int] = None):
    """``tail_attend`` as one rank's body (models/ranks.py) on tables split
    by their bucket columns: tail_k / tail_v (B, Z, Cl, K, hd) hold
    columns [col0, col0 + Cl) of this rank's B slots.  The rank's bucket
    products (``tail_products_op``) are gathered over the ranks that split
    the columns (a ``Collective`` "gather" along C) and selected
    (``tail_select_op``): the estimates are bitwise the unsharded
    ``tail_scores``' (a product depends on its own column alone).  The
    softmax over T and the one-chunk count sketch of its weights follow
    on every rank alike; each rank contracts its own columns of the
    sketch with its value tables, and the partial (B, Z, K, rows, hd)
    estimates are summed over the ranks (a "sum") before the median over
    rows.  Returns (m, l, acc) as ``tail_attend``."""
    B, Sq, K, R, hd = q.shape
    T = pos_hash.bk.shape[1]
    prod = kops.tail_products_op(_query_rows(q), tail_k,
                                 use_kernel=use_kernel)  # (B, K, Z, N, Cl)
    prod = yield Collective("gather", prod, dim=4)
    est = kops.tail_select_op(prod.contiguous(), coeffs, T,
                              use_kernel=use_kernel)
    m, l, w = _tail_softmax(est, fold_base, scale, (B, K, R, Sq))
    est_v = _tail_values(w, pos_hash, prod.shape[4], tail_v, col0,
                         (B, K, R, Sq), use_kernel, slab)
    est_v = yield Collective("sum", est_v)
    return m, l, _tail_median(est_v, (B, K, R, Sq, hd))


def _query_rows(q: torch.Tensor) -> torch.Tensor:
    """(B, Sq, K, R, hd) queries as the score kernels' (B, K, R*Sq, hd)
    contiguous f32 rows."""
    B, Sq, K, R, hd = q.shape
    return q.permute(0, 2, 3, 1, 4).reshape(B, K, R * Sq,
                                            hd).float().contiguous()


def _tail_softmax(est: torch.Tensor, fold_base: torch.Tensor, scale: float,
                  shape: Tuple[int, int, int, int]):
    """(m, l, w) of the live span's softmax over T from the estimates
    (B, K, R*Sq, T)."""
    B, K, R, Sq = shape
    T = est.shape[-1]
    s = est.view(B, K, R, Sq, T) * scale
    live = (torch.arange(T, device=est.device)[None, :]
            < fold_base[:, None])[:, None, None, None, :]     # (B,1,1,1,T)
    s = torch.where(live, s, -1e30)
    m = s.max(dim=-1).values                                  # (B,K,R,Sq)
    w = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    return m, w.sum(dim=-1), w


def _tail_values(w: torch.Tensor, pos_hash: PosHash, C: int,
                 tail_v: torch.Tensor, col0: int,
                 shape: Tuple[int, int, int, int],
                 use_kernel: Optional[bool], slab: Optional[int]
                 ) -> torch.Tensor:
    """The value estimates (B, Z, K, rows, hd) of the softmax weights w
    against value tables tail_v (B, Z, Cl, K, hd) holding bucket columns
    [col0, col0 + Cl) of C: over all C, the whole contraction; over a
    column shard, its part of the sum over columns."""
    B, K, R, Sq = shape
    Cl = tail_v.shape[2]
    bk, sg, links = pos_hash                                  # (Z, T)
    Z, T = bk.shape
    # CS is linear: sum_j w_j v_j ~= < CS_z(w), tail_v[z] > per row z
    RS = R * Sq
    cw = kops.count_sketch_op(w.reshape(B * K * RS, T), bk, sg, C,
                              index=links, use_kernel=use_kernel, chunks=1)
    rows = padded_rows(RS) if slab is None else slab_rows(RS, slab)
    cw = cw.view(Z, B, K, RS, C)
    if Cl != C:
        cw = cw[..., col0:col0 + Cl]
    cw = F.pad(cw.permute(1, 0, 2, 3, 4),
               (0, 0, 0, rows - RS))                         # (B,Z,K,rows,Cl)
    tv = tail_v.float().permute(0, 1, 3, 2, 4)
    if slab is None or rows == slab:
        return torch.matmul(cw, tv)
    return torch.cat([torch.matmul(c.contiguous(), tv)
                      for c in cw.split(slab, dim=3)], dim=3)


def _tail_median(est_v: torch.Tensor, shape) -> torch.Tensor:
    """acc (B, K, R, Sq, hd): the median over the Z rows of the value
    estimates (B, Z, K, rows, hd), padding rows dropped."""
    B, K, R, Sq, hd = shape
    acc = median_rows(est_v[:, :, :, :R * Sq].permute(1, 0, 2, 3, 4))
    return acc.reshape(B, K, R, Sq, hd)


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


def two_span_output(fold_base: torch.Tensor, o: torch.Tensor,
                    m_e: torch.Tensor, l_e: torch.Tensor, acc_e: torch.Tensor,
                    m_t: torch.Tensor, l_t: torch.Tensor, acc_t: torch.Tensor
                    ) -> torch.Tensor:
    """The two-span output (B, K, R, Sq, hd): the spans' statistics merged
    (``merge_spans``) where ``fold_base`` (B,) > 0, and the exact span's
    own output ``o`` verbatim where nothing was folded, so such a slot
    decodes bitwise as a sketch-free engine."""
    merged = merge_spans(m_e, l_e, acc_e, m_t, l_t, acc_t)
    return torch.where((fold_base > 0)[:, None, None, None, None], merged, o)


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
