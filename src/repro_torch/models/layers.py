"""Shared layers of the port (``repro/models/layers.py``): norms, RoPE,
GQA/MQA attention over the paged KV pool (decode and chunked prefill),
over a dense per-slot cache (the hybrid family's decode),
full-sequence causal attention (the training path), the GLU FFN,
embeddings, the LM head (dense, tied or FCS-sketched) and the training
loss.

Plain functions over explicit parameter dicts.  Weights are bf16;
norms, softmax statistics and logits are f32.

Row padding.  A serve engine's decode step carries its B hidden rows
padded with zero rows to its step rows, ``padded_rows(max_batch)``, a
multiple of ``ROW_TILE``; a verify step's B*(spec_k+1) rows pad to a
whole number of step-row slabs, and every GEMM and row reduction of the
step runs over those slabs one at a time (``by_slabs``), so each launch
has the decode step's shape whatever spec_k is.  Library GEMMs and
reductions pick their algorithm (split-K, block shape) by shape, so
only equal shapes make a verify row bitwise the decode row at its
position — the property greedy speculative decoding rests on.  At
decode sizes the GEMMs are bound by the weights' bytes, which padding
does not add to; a verify step of n slabs reads the weights n times.
Chunk prefill runs at the same shape in every engine and is not padded.

Paged KV pool layout: ``(NB + 1, bs, K, hd)`` per layer.  Blocks
``[0, NB)`` are the pool the block tables index; block ``NB`` is a write
sink.  JAX's ``.at[phys, off].set(mode="drop")`` drops writes whose block
id is out of range; here such writes (table entries == NB: unallocated
or invalidated rows, and chunk rows past the slot's table) land in the
sink instead, which no table references and no attention reads — so the
write stays one ``index_put_`` with no host sync.  Attention sees only
the ``[:NB]`` view.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.ranks import Collective, mesh_collect, run
from repro_torch.models.sharding import (current_rules, entry_axes,
                                         from_local, gathered, is_dtensor,
                                         local_sum_mean, norm_spec, placed,
                                         placements, rewrap, shard,
                                         single_device_mesh, to_local,
                                         unwrap)

PDTYPE = torch.bfloat16  # parameter dtype
ROW_TILE = 64            # decode / verify rows pad to a multiple of this
_PRIME = 2_147_483_647   # core/hashes.py:PRIME, the head hash's modulus


def padded_rows(M: int) -> int:
    """M rounded up to a multiple of ``ROW_TILE``: the rows a decode or
    verify step of M rows runs its GEMMs and row reductions at, and the
    rows of the tail span's value contraction (serve/kv_sketch.py)."""
    return max(ROW_TILE, -(-M // ROW_TILE) * ROW_TILE)


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(M, n) -> (rows, n): zero rows appended."""
    return F.pad(x, (0, 0, 0, rows - x.shape[0])) if rows > x.shape[0] else x


def slab_rows(M: int, slab: int) -> int:
    """M rounded up to a whole number of ``slab``-row slabs."""
    return -(-M // slab) * slab


def _rows_local(x: torch.Tensor):
    """(x's shard with its last dim whole, its mesh, the placements of
    that shard): a DTensor activation on its way into a row-wise local
    computation."""
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == last else p
               for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return x.to_local(), x.device_mesh, pl


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of activations x (..., d) and a weight w (d, e).  A
    DTensor x of three or more dims runs on each rank's rows: x's last
    dim gathered, w gathered whole (FSDP: the gradient goes back as a
    reduce-scatter), one local matmul, the result split as x's rows.
    DTensor's own matmul would fold (B, S) into one dim, which older
    releases cannot do when S is split (context sharding)."""
    if not (is_dtensor(x) and x.ndim >= 3):
        return x @ w
    xl, mesh, pl = _rows_local(x)
    return placed(xl @ gathered(w, pl), mesh, pl)


def by_slabs(fn, x: torch.Tensor, slab: Optional[int]) -> torch.Tensor:
    """``fn`` of a row-wise computation over x's rows, run on successive
    slabs of ``slab`` rows and concatenated, so that every launch has the
    shape of one slab (the decode step's; see row padding above).  One
    call when ``slab`` is None or x has at most ``slab`` rows."""
    if slab is None or x.shape[0] <= slab:
        return fn(x)
    return torch.cat([fn(t) for t in x.split(slab)])


# ---------------------------------------------------------------------------
# Norms, RoPE
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Gemma-style RMSNorm with a ``1 + scale`` gain, computed in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, n, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA)
# ---------------------------------------------------------------------------


def _project_qkv_rope(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, slab: Optional[int] = None):
    """Project (+bias), split heads, rope q and k at ``positions``
    ((S,) or (B, S)).  x is (B, S, d), or (rows, d) holding the B*S rows
    of (B, S) ``positions`` first and zero padding after (the paged
    paths' layout): the projections then run at all the rows, in slabs
    of ``slab`` rows (``by_slabs``).  Shared by decode, verify and
    chunked prefill."""
    if x.ndim == 3:
        B, S = x.shape[:2]
    else:
        B, S = positions.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    proj = lambda w: by_slabs(lambda t: linear(t, w), x, slab)
    q = proj(p["wq"])
    kn = proj(p["wk"])
    vn = proj(p["wv"])
    if cfg.qkv_bias:
        q, kn, vn = q + p["bq"], kn + p["bk"], vn + p["bv"]
    if x.ndim == 2:
        q, kn, vn = q[:B * S], kn[:B * S], vn[:B * S]
        q = shard(q, "batch", "heads")
        kn = shard(kn, "batch", "kv_heads")
        vn = shard(vn, "batch", "kv_heads")
    else:
        # a sharded projection's head dim splits only where the heads do
        q = shard(q, "batch", "seq", "heads")
        kn = shard(kn, "batch", "seq", "kv_heads")
        vn = shard(vn, "batch", "seq", "kv_heads")
    q = shard(q.reshape(B, S, H, hd), "batch", "seq", "heads", None) \
        if x.ndim == 3 else q.reshape(B, S, H, hd)
    q = rope(q, positions, cfg.rope_theta)
    kn = rope(kn.reshape(B, S, K, hd), positions, cfg.rope_theta)
    return q, kn, vn.reshape(B, S, K, hd)


def paged_attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 tables: torch.Tensor, start: torch.Tensor,
                 fold_base: torch.Tensor, use_kernel: Optional[bool],
                 tail: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 sketch: Optional[dict] = None,
                 tail_slab: Optional[int] = None) -> torch.Tensor:
    """Attend straight through the block tables (the reference's
    ``_kernel_paged_attention``).  qg: (B, Sq, K, R, hd); k/v: the
    (NB, bs, K, hd) pools; start: (B,) position of each slot's query
    row 0.  With ``tail`` (this layer's (B, Z, C, K, hd) k and v tables)
    and ``sketch`` (serve/kv_sketch.py) the exact span is
    [fold_base, start + i] and the tail supplies [0, fold_base), merged
    with online-softmax statistics (its value contraction in slabs of
    ``tail_slab`` rows, ``kv_sketch.tail_attend``); slots with
    fold_base == 0 keep the exact output verbatim, so a window covering
    the context decodes bitwise as a sketch-free engine.  Returns
    (B, Sq, K, R, hd) in qg's dtype."""
    m_e, l_e, acc_e = kops.paged_attention_op(qg, k, v, tables, start,
                                              fold_base,
                                              use_kernel=use_kernel)
    o = acc_e / torch.clamp(l_e, min=1e-30)[..., None]  # (B,K,R,Sq,hd)
    if tail is not None:
        from repro_torch.serve import kv_sketch as kvs
        m_t, l_t, acc_t = kvs.tail_attend(
            qg, tail[0], tail[1], sketch["coeffs"], sketch["pos_hash"],
            fold_base, 1.0 / math.sqrt(qg.shape[-1]), use_kernel=use_kernel,
            slab=tail_slab)
        o = kvs.two_span_output(fold_base, o, m_e, l_e, acc_e, m_t, l_t,
                                acc_t)
    return o.permute(0, 3, 1, 2, 4).to(qg.dtype)


def paged_self_attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
                         pool_k: torch.Tensor, pool_v: torch.Tensor,
                         positions: torch.Tensor, tables: torch.Tensor,
                         fold_base: torch.Tensor,
                         use_kernel: Optional[bool] = None,
                         tail: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                         sketch: Optional[dict] = None,
                         slab: Optional[int] = None) -> torch.Tensor:
    """Attention of new rows against the paged pool — the reference's
    ``_paged_decode_attention`` (one token per slot, x (B, 1, d),
    positions (B, 1)) and ``chunk_attention`` (one prompt chunk of one
    slot, x (1, C, d), positions (1, C) = start + arange(C)) in one, and
    the verify step's (B, K + 1) rows of consecutive positions.  x may
    also be the B*S rows padded to (rows, d) (see ``padded_rows``); the
    result then has the same padded layout, and with ``slab`` (the
    decode and verify steps' step rows) the projections run over slabs
    of that many rows and the tail span's value contraction over slabs
    of ``padded_rows(H // K)`` rows, the decode step's.
    Each new KV row scatters through its slot's (B, nb) block-table row
    into the layer's pool in place (the JAX version donated the pool);
    rows on unallocated entries (== NB) or past the table land in the
    write sink, so an idle slot or a tail chunk's padding mutates no live
    block.  Then query i of slot b attends causally — key p visible iff
    ``fold_base[b] <= p <= positions[b, i]`` — through the tables, so a
    chunk sees earlier chunks and shared prefix blocks; ``tail`` /
    ``sketch`` add the folded span (see ``paged_attend``).  Pools are
    (NB + 1, bs, K, hd) with the sink last.  Returns (B, S, d).

    DTensor pools (and tails): on a one-device mesh the layer runs on the
    local tensors (the card's kernels, bitwise the unsharded layer); on a
    larger mesh as ``_paged_self_attention_sharded``: the pool split by
    blocks and the tail by bucket columns over ``kv_blocks``, both by
    slots over ``batch``, for decode, verify and chunk rows alike."""
    if is_dtensor(pool_k):
        mesh = single_device_mesh(pool_k)
        if mesh is None:
            return _paged_self_attention_sharded(p, x, cfg, pool_k, pool_v,
                                                 positions, tables,
                                                 fold_base, use_kernel, slab,
                                                 tail, sketch)
        return rewrap(paged_self_attention(
            *unwrap((p, x, cfg, pool_k, pool_v, positions, tables,
                     fold_base, use_kernel, tail, sketch, slab))), mesh)
    B, S = positions.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    NB, bs = pool_k.shape[0] - 1, pool_k.shape[1]
    nb_slot = tables.shape[1]
    q, kn, vn = _project_qkv_rope(p, x, cfg, positions, slab)
    blk = torch.div(positions, bs, rounding_mode="floor").long()
    phys = torch.gather(tables, 1, blk.clamp(max=nb_slot - 1))
    phys = torch.where(blk < nb_slot, phys, NB).long()
    off = (positions % bs).long()
    pool_k.index_put_((phys, off), kn.to(pool_k.dtype))
    pool_v.index_put_((phys, off), vn.to(pool_v.dtype))
    qg = q.reshape(B, S, K, H // K, hd)
    o = paged_attend(qg, pool_k[:NB], pool_v[:NB], tables,
                     positions[:, 0].contiguous(), fold_base, use_kernel,
                     tail, sketch,
                     None if slab is None else padded_rows(H // K))
    if x.ndim == 2:
        return by_slabs(lambda t: t @ p["wo"],
                        pad_rows(o.reshape(B * S, H * hd), x.shape[0]), slab)
    return linear(o.reshape(B, S, H * hd), p["wo"])


def _local_range(t: torch.Tensor, dim: int) -> Tuple[int, int]:
    """(global offset, local length) of this rank's shard of DTensor
    ``t`` along ``dim``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return int(off[dim]), int(shape[dim])


def put_rows_(local: torch.Tensor, idx: Tuple[torch.Tensor, ...],
              ok: torch.Tensor, rows: torch.Tensor) -> None:
    """``local[idx] = rows`` for the rows where ``ok``, leaving the others'
    destinations as they were, with no data-dependent shape: the write
    adds (rows - old) as integers of the element's width (exact, wrapping)
    where ``ok`` and 0 elsewhere, so a row that is not ours may share a
    destination with one that is.  Rows that are ours hit distinct
    destinations (a slot's new rows), apart from a write sink."""
    itype = {2: torch.int16, 4: torch.int32}[local.element_size()]
    bits = local.view(itype)
    new = rows.to(local.dtype).view(itype)
    keep = ok.reshape(ok.shape + (1,) * (new.ndim - ok.ndim))
    delta = torch.where(keep, new - bits[idx], torch.zeros_like(new))
    bits.index_put_(idx, delta, accumulate=True)


def merge_split_stats(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor):
    """Merge split-KV statistics over the ranks that split the keys, as a
    body of models/ranks.py: the max of m (a "max"), and l and acc
    rescaled to it and summed (two "sum"s).  m, l (B, K, R, S) and acc
    (B, K, R, S, hd) are this rank's, its rows on dim 0."""
    mg = yield Collective("max", m)
    corr = torch.exp(m - mg)
    l = yield Collective("sum", l * corr)
    acc = yield Collective("sum", acc * corr[..., None])
    return mg, l, acc


def paged_attention_rank(ql: torch.Tensor, kl: torch.Tensor,
                         vl: torch.Tensor, pos: torch.Tensor,
                         tables: torch.Tensor, fold_base: torch.Tensor,
                         pool_k: torch.Tensor, pool_v: torch.Tensor,
                         lo: int, NB: int, use_kernel: Optional[bool],
                         tail: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                         sketch: Optional[dict] = None, col0: int = 0,
                         tail_slab: Optional[int] = None):
    """One rank's attention over a pool split by blocks, as a body of
    models/ranks.py whose collectives run over the ranks that split the
    blocks (and the tail's columns).  ql (B, S, K, R, hd), kl / vl
    (B, S, K, hd), pos / tables / fold_base: this rank's B slots' rows;
    pool_k / pool_v: its (n, bs, K, hd) blocks [lo, lo + n) of the NB + 1
    (the sink last); tail: its (B, Z, Cl, K, hd) k and v tables, bucket
    columns [col0, col0 + Cl).

    The rank writes the new rows whose block it holds (``put_rows_``),
    attends its queries to those blocks through
    ``kops.paged_attention_op`` (the tables remapped to local block ids,
    the others' blocks dead entries) and merges the ranks' (m, l, acc)
    (a "max" and two "sum"s); with a tail, the folded span's statistics
    come from ``kv_sketch.tail_attend_rank`` and merge with the exact
    span's as in ``paged_attend``.  Returns o (B, K, R, S, hd) f32."""
    n, bs = pool_k.shape[0], pool_k.shape[1]
    nb_slot = tables.shape[1]
    blk = torch.div(pos, bs, rounding_mode="floor")
    phys = torch.gather(tables, 1, blk.clamp(max=nb_slot - 1))
    phys = torch.where(blk < nb_slot, phys, NB)
    ours = (phys >= lo) & (phys < lo + n)
    idx = ((phys - lo).clamp(0, n - 1), pos % bs)
    put_rows_(pool_k, idx, ours, kl)
    put_rows_(pool_v, idx, ours, vl)
    # attend: the blocks this rank holds; the sink and the others' are
    # dead entries (n)
    held = (tables >= lo) & (tables < lo + n) & (tables < NB)
    local = torch.where(held, tables - lo, n).to(torch.int32)
    fb = fold_base.to(torch.int32)
    m, l, acc = kops.paged_attention_op(
        ql, pool_k, pool_v, local, pos[:, 0].to(torch.int32).contiguous(),
        fb, use_kernel=use_kernel)
    mg, l, acc = yield from merge_split_stats(m, l, acc)
    o = acc / torch.clamp(l, min=1e-30)[..., None]            # (B,K,R,S,hd)
    if tail is None:
        return o
    from repro_torch.serve import kv_sketch as kvs
    m_t, l_t, acc_t = yield from kvs.tail_attend_rank(
        ql, tail[0], tail[1], sketch["coeffs"], sketch["pos_hash"], fb,
        1.0 / math.sqrt(ql.shape[-1]), col0, use_kernel, tail_slab)
    return kvs.two_span_output(fb, o, mg, l, acc, m_t, l_t, acc_t)


def _paged_self_attention_sharded(p: dict, x: torch.Tensor,
                                  cfg: ModelConfig, pool_k: torch.Tensor,
                                  pool_v: torch.Tensor,
                                  positions: torch.Tensor,
                                  tables: torch.Tensor,
                                  fold_base: torch.Tensor,
                                  use_kernel: Optional[bool],
                                  slab: Optional[int],
                                  tail: Optional[Tuple[torch.Tensor,
                                                       torch.Tensor]] = None,
                                  sketch: Optional[dict] = None
                                  ) -> torch.Tensor:
    """``paged_self_attention`` on a pool split over its block axis (the
    rules' ``kv_blocks``: split-KV) with its rows split over ``batch``,
    and a tail (if any) split by bucket columns over ``kv_blocks`` and by
    slots over ``batch`` (launch/shardings.py:_tail_spec).  The
    projections run as DTensor ops; each rank then runs
    ``paged_attention_rank`` on its slots, blocks and columns, its
    collectives over the ``kv_blocks`` axes.  The batch and block axes
    must not overlap."""
    B, S = positions.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    rules = current_rules() or {}
    mesh = pool_k.device_mesh
    b = rules.get("batch")
    kb_axes = entry_axes(rules.get("kv_blocks"))
    if set(entry_axes(b)) & set(kb_axes):
        raise ValueError("the batch and kv_blocks axes overlap")
    q, kn, vn = _project_qkv_rope(p, x, cfg, positions, slab)
    rs = norm_spec((b, None, None, None, None))

    def mine(t, sp):        # this rank's rows; a plain t is replicated
        if not is_dtensor(t):
            t = from_local(t, mesh, (None,) * t.ndim)
        return to_local(t, sp)

    col0, tl = 0, None
    if tail is not None:
        if not is_dtensor(tail[0]):
            raise ValueError("a sharded pool's tails must be DTensors "
                             "(launch/shardings.py:cache_pspecs)")
        want = placements(norm_spec((b, None, rules.get("kv_blocks"), None,
                                     None)), mesh)
        tk, tv = (t.redistribute(mesh, want) for t in tail)
        tl, col0 = (tk.to_local(), tv.to_local()), _local_range(tk, 2)[0]
    lo, _ = _local_range(pool_k, 0)
    body = paged_attention_rank(
        mine(q, rs[:4]).reshape(-1, S, K, H // K, hd), mine(kn, rs[:4]),
        mine(vn, rs[:4]), mine(positions, rs[:2]).long(),
        mine(tables, rs[:2]).long(), mine(fold_base, rs[:1]),
        pool_k.to_local(), pool_v.to_local(), lo, pool_k.shape[0] - 1,
        use_kernel, tl, sketch, col0,
        None if slab is None else padded_rows(H // K))
    o = run(body, mesh_collect(mesh, kb_axes))
    o = o.permute(0, 3, 1, 2, 4).to(q.dtype).reshape(-1, S, H * hd)
    o = from_local(o, mesh, rs[:3])
    if x.ndim == 2:
        return by_slabs(lambda t: t @ p["wo"],
                        pad_rows(o.reshape(B * S, H * hd), x.shape[0]), slab)
    return linear(o, p["wo"])


def init_kv_cache(cfg: ModelConfig, n: int, batch: int, max_seq: int,
                  dev: torch.device,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """n stacked dense slot caches {"k", "v"}: (n, batch, max_seq, K, hd)
    zeros, one row per slot and position (the hybrid family's shared
    attention, one cache per application of a shared block)."""
    shape = (n, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def dense_decode_attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
                           cache_k: torch.Tensor, cache_v: torch.Tensor,
                           index: torch.Tensor) -> torch.Tensor:
    """Single-token decode against a dense per-slot cache (the reference's
    ``decode_attention`` with ``tables=None`` and a (B,) ``index``).
    x: (B, 1, d); cache_k / cache_v: (B, S_max, K, hd), updated in place:
    slot b writes its new row at its own ``index[b]`` and attends keys
    ``arange(S_max) <= index[b]``, f32 scores and softmax.  Rows above
    ``index[b]`` (an earlier occupant's, or never written) are masked.
    Returns (B, 1, d).  A DTensor cache split over slots and positions
    (the rules' ``batch`` and ``kv_seq``) runs as
    ``_dense_decode_attention_sharded``, one on a one-device mesh on its
    local tensors."""
    if is_dtensor(cache_k):
        mesh = single_device_mesh(cache_k)
        if mesh is None:
            return _dense_decode_attention_sharded(p, x, cfg, cache_k,
                                                   cache_v, index)
        return rewrap(dense_decode_attention(
            *unwrap((p, x, cfg, cache_k, cache_v, index))), mesh)
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    q, kn, vn = _project_qkv_rope(p, x, cfg, index[:, None])
    slots = torch.arange(B, device=x.device)
    cache_k.index_put_((slots, index.long()), kn[:, 0].to(cache_k.dtype))
    cache_v.index_put_((slots, index.long()), vn[:, 0].to(cache_v.dtype))
    S = cache_k.shape[1]
    qg = q.reshape(B, K, H // K, hd)                          # Sq = 1
    s = torch.einsum("bkrh,bskh->bkrs", qg, cache_k).float() * (
        1.0 / math.sqrt(hd))
    visible = torch.arange(S, device=x.device)[None, :] <= index[:, None]
    s = s.masked_fill(~visible[:, None, None, :], -1e30)
    pr = torch.softmax(s, dim=-1).to(cache_v.dtype)
    o = torch.einsum("bkrs,bskh->bkrh", pr, cache_v)
    return linear(o.reshape(B, 1, H * hd), p["wo"])


def _dense_decode_attention_sharded(p: dict, x: torch.Tensor,
                                    cfg: ModelConfig, cache_k: torch.Tensor,
                                    cache_v: torch.Tensor,
                                    index: torch.Tensor) -> torch.Tensor:
    """``dense_decode_attention`` on a cache split over slots (``batch``)
    and positions (``kv_seq``; split-KV): each rank writes the new row of
    each of its slots whose position it holds (``put_rows_``), attends
    its slots' query to the positions it holds, and the ranks merge
    their softmax statistics over the ``kv_seq`` axes."""
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    rules = current_rules() or {}
    mesh = cache_k.device_mesh
    b = rules.get("batch")
    ks_axes = entry_axes(rules.get("kv_seq"))
    rs = norm_spec((b, None, None, None, None))
    q, kn, vn = _project_qkv_rope(p, x, cfg, index[:, None])

    def mine(t, sp):
        if not is_dtensor(t):
            t = from_local(t, mesh, (None,) * t.ndim)
        return to_local(t, sp)

    ql = mine(q, rs[:4]).float()                             # (Bl,1,H,hd)
    kl, vl = mine(kn, rs[:4])[:, 0], mine(vn, rs[:4])[:, 0]
    pos = mine(index, rs[:1]).long()
    ck, cv = cache_k.to_local(), cache_v.to_local()
    lo, n = _local_range(cache_k, 1)
    Bl = ck.shape[0]
    ours = (pos >= lo) & (pos < lo + n)
    slots = torch.arange(Bl, device=ck.device)
    idx = (slots, (pos - lo).clamp(0, n - 1))
    put_rows_(ck, idx, ours, kl)
    put_rows_(cv, idx, ours, vl)
    qg = ql.reshape(Bl, K, H // K, hd)
    s = torch.einsum("bkrh,bskh->bkrs", qg, ck.float()) * (
        1.0 / math.sqrt(hd))
    kpos = lo + torch.arange(n, device=ck.device)
    visible = (kpos[None, :] <= pos[:, None])[:, None, None, :]
    s = torch.where(visible, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)[..., None]                            # (Bl,K,R,1)
    pr = torch.where(visible, torch.exp(s - m), torch.zeros_like(s))
    l = pr.sum(dim=-1)[..., None]
    acc = torch.einsum("bkrs,bskh->bkrh", pr.to(cv.dtype).float(),
                       cv.float())[:, :, :, None]            # (Bl,K,R,1,hd)
    m, l, acc = run(merge_split_stats(m, l, acc),
                    mesh_collect(mesh, ks_axes))
    o = (acc / torch.clamp(l, min=1e-30)[..., None]).to(ck.dtype)
    o = from_local(o.reshape(Bl, 1, H * hd), mesh, rs[:3])
    return linear(o, p["wo"])


def causal_attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     kv_chunk: int = 1024) -> torch.Tensor:
    """Full-sequence causal attention of ``forward(mode="train")`` and of
    zamba2's prompt prefill, differentiated by autograd: the reference's
    ``causal_attention``, an online softmax over KV chunks of ``kv_chunk``
    (``_flash_attention``), each chunk's body recomputed in the backward,
    so a layer's backward holds O(S * kv_chunk) scores, never the
    (B, H, S, S) ones.  x: (B, S, d)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv_rope(p, x, cfg, positions)
    # replicate KV at the (small) K-head stage: the context-sharded seq
    # dim is all-gathered here, before the R-fold head broadcast
    k = shard(k, "batch", "kv_seq", None, None)
    v = shard(v, "batch", "kv_seq", None, None)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    o = _flash_attention(q, k, v, min(kv_chunk, S))
    o = shard(o.reshape(B, S, H * hd), "batch", "seq", None)
    return linear(o, p["wo"])


def _pin(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor):
    """The online softmax's carries on the q / context sharding."""
    return (shard(m, "batch", None, "seq"), shard(l, "batch", None, "seq"),
            shard(acc, "batch", "seq", None, None))


def _carry(like: torch.Tensor, shape: Tuple[int, ...], fill: float,
           *axes: Optional[str]) -> torch.Tensor:
    """An f32 carry of ``shape`` filled with ``fill`` on ``like``'s
    device; a DTensor placed by ``axes`` when ``like`` is one inside a
    rules context (so the first chunk's ops see a placed carry)."""
    rules = current_rules()
    if not (rules and is_dtensor(like)):
        return torch.full(shape, fill, dtype=torch.float32,
                          device=like.device)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.models.sharding import placements, spec_for
    mesh = like.device_mesh
    pl = placements(spec_for(axes, rules), mesh)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    t = torch.full(local, fill, dtype=torch.float32,
                   device=like.to_local().device)
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _flash_chunk(q: torch.Tensor, kj: torch.Tensor, vj: torch.Tensor,
                 k0: int, scale: float, m: torch.Tensor, l: torch.Tensor,
                 acc: torch.Tensor):
    """One KV chunk (keys [k0, k0 + kc)) of the online softmax, in the
    reference's order: scores in f32 masked to -1e30, the new max, p,
    the correction, l, then acc from p in v's dtype."""
    S, kc = q.shape[1], kj.shape[1]
    q_pos = torch.arange(S, device=q.device)
    k_pos = k0 + torch.arange(kc, device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]                  # (S, kc)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kj).float() * scale
    s = s.masked_fill(~mask, -1e30)
    s = shard(s, "batch", None, "seq", None)
    m_new = torch.maximum(m, s.amax(dim=-1))
    pr = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + pr.sum(dim=-1)
    acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", pr.to(vj.dtype), vj).float()
    return _pin(m_new, l, acc)


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kc: int) -> torch.Tensor:
    """Online-softmax causal attention of q, k, v (B, S, H, hd) (KV
    expanded to H heads) over KV chunks of kc keys: the keys padded to a
    multiple of kc (the padding fails the causal test), f32 running
    (max, sum, acc), each chunk under ``checkpoint``, as the reference's
    ``jax.checkpoint`` scan body.  Returns (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    pad = (-S) % kc
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    m, l, acc = _pin(_carry(q, (B, H, S), -1e30, "batch", None, "seq"),
                     _carry(q, (B, H, S), 0.0, "batch", None, "seq"),
                     _carry(q, (B, S, H, hd), 0.0, "batch", "seq", None,
                            None))
    for k0 in range(0, S + pad, kc):
        m, l, acc = checkpoint(_flash_chunk, q, k[:, k0:k0 + kc],
                               v[:, k0:k0 + kc], k0, scale, m, l, acc,
                               use_reentrant=False)
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GLU FFN, embedding, LM head
# ---------------------------------------------------------------------------


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if name == "gelu" else F.silu(x)


def glu_ffn(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    g = linear(x, p["w_gate"])
    u = linear(x, p["w_up"])
    h = _act(act, g) * u
    if h.ndim == 3:
        h = shard(h, "batch", "seq", "ff")
    return linear(h, p["w_down"])


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``.  DTensor tokens gather on each
    rank's own tokens from the whole (gathered) table."""
    if is_dtensor(tokens):
        mesh, pl = tokens.device_mesh, tuple(tokens.placements)
        x = placed(gathered(emb, pl)[tokens.to_local()], mesh, pl)
    else:
        x = emb[tokens]
    return shard(x, "batch", "seq", "embed") if x.ndim == 3 else x


def head_sketch_len(cfg: ModelConfig) -> int:
    return cfg.sketch.head_hash_len or cfg.d_model // 4


@functools.lru_cache(maxsize=None)
def _head_hash_tables(seed: int, d: int, J: int):
    """The FCS-sketched head's 2-wise independent hash (h, sg) over the
    d_model activation entries, as numpy arrays: the reference's
    ``layers._head_hash_tables`` draw for draw, so both packages sketch
    with the same buckets and signs."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    ah = rng.randint(1, _PRIME, dtype=np.int64)
    bh = rng.randint(0, _PRIME, dtype=np.int64)
    as_ = rng.randint(1, _PRIME, dtype=np.int64)
    bs = rng.randint(0, _PRIME, dtype=np.int64)
    idx = np.arange(d, dtype=np.int64)
    h = (((ah * idx + bh) % _PRIME) % J).astype(np.int32)
    sg = (1.0 - 2.0 * (((as_ * idx + bs) % _PRIME) % 2)).astype(np.float32)
    return h, sg


@functools.lru_cache(maxsize=None)
def head_hash(seed: int, d: int, J: int, device: torch.device):
    """``_head_hash_tables`` on ``device`` as (h int32, sg f32, bucket
    links), built once per (seed, d, J, device)."""
    from repro_torch.kernels.count_sketch import bucket_links
    h, sg = _head_hash_tables(seed, d, J)
    h = torch.as_tensor(h, device=device)
    sg = torch.as_tensor(sg, device=device)
    return h, sg, bucket_links(h, sg, J)


class _ActivationSketch(torch.autograd.Function):
    """Count sketch of activation rows x (M, d) -> (M, J) under one hash
    row; its gradient is the transpose, the signed lookup."""

    @staticmethod
    def forward(ctx, x, h, sg, links, J):
        ctx.save_for_backward(h, sg)
        return kops.count_sketch_op(x, h, sg, J, index=links)

    @staticmethod
    def backward(ctx, g):
        h, sg = ctx.saved_tensors
        return (kops.unsketch_op(g.contiguous(), h, sg), None, None, None,
                None)


def _head_io(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """(x_eff, W_eff) of the vocab projection: x and the dense head (or
    the tied embed), or, with the FCS-sketched head (paper Section 4.2),
    the per-token count sketch of x into J = ``head_sketch_len`` buckets
    and the (J, Vp) sketched head.  The reference forms the sketch as a
    one-hot product, O(d J) a token; here it is ``count_sketch_op``,
    O(d)."""
    if cfg.sketch.sketched_head:
        J = head_sketch_len(cfg)
        h, sg, links = head_hash(cfg.sketch.seed, cfg.d_model, J, x.device)
        xs = _ActivationSketch.apply(
            x.reshape(-1, x.shape[-1]).contiguous(), h, sg, links, J)
        return xs.reshape(*x.shape[:-1], J), params["head"]
    head = params["head"] if params.get("head") is not None \
        else params["embed"].t()
    return x, head


def logits_fn(params: dict, x: torch.Tensor, cfg: ModelConfig,
              rows: Optional[int] = None,
              slab: Optional[int] = None) -> torch.Tensor:
    """Final hidden -> vocab logits (f32), dense, tied or sketched head.
    ``rows`` keeps the first rows of a padded (rows', d) x (the paged
    paths' layout; the projection runs at all of them, in slabs of
    ``slab`` rows)."""
    def project(t):
        t, head = _head_io(params, t, cfg)
        return linear(t, head)

    out = by_slabs(project, x, slab)
    if out.ndim == 3:
        out = shard(out, "batch", "seq", "vocab")
    return (out if rows is None else out[:rows]).float()


def _ce_chunk(x: torch.Tensor, head_c: torch.Tensor, labels: torch.Tensor,
              c0: int, m: torch.Tensor, l: torch.Tensor,
              gold: torch.Tensor):
    """One vocab chunk of the online logsumexp: columns [c0, c0 + vc)."""
    logits = (x @ head_c).float()                       # (B, S, vc)
    vc = head_c.shape[-1]
    m_new = torch.maximum(m, logits.max(dim=-1).values)
    l = l * torch.exp(m - m_new) + torch.exp(
        logits - m_new[..., None]).sum(dim=-1)
    idx = labels - c0
    valid = (idx >= 0) & (idx < vc)
    g = logits.gather(-1, idx.clamp(0, vc - 1)[..., None])[..., 0]
    return m_new, l, gold + torch.where(valid, g, torch.zeros_like(g))


def cross_entropy(params: dict, x: torch.Tensor, labels: torch.Tensor,
                  cfg: ModelConfig, vocab_chunk: int = 8192) -> torch.Tensor:
    """Mean next-token cross entropy over (B, S) (the reference's
    ``cross_entropy``), through ``_head_io`` (dense, tied or sketched
    head): a vocab-chunked online logsumexp, each chunk
    recomputed in the backward, so the (B, S, V) f32 logits never exist
    whole.  The logsumexp runs over all ``padded_vocab`` columns of the
    head (padded rows carry init weights, as in the reference).  The
    reference pads the head to a whole number of chunks and masks the
    padding; here the last chunk is narrower, which is the same sum."""
    if is_dtensor(x):
        return _cross_entropy_sharded(params, x, labels, cfg, vocab_chunk)
    B, S, _ = x.shape
    x, head = _head_io(params, x, cfg)
    V = head.shape[-1]
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    gold = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for c0 in range(0, V, vocab_chunk):
        m, l, gold = checkpoint(_ce_chunk, x, head[:, c0:c0 + vocab_chunk],
                                labels, c0, m, l, gold, use_reentrant=False)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return (lse - gold).mean()


def _cross_entropy_sharded(params: dict, x: torch.Tensor,
                           labels: torch.Tensor, cfg: ModelConfig,
                           vocab_chunk: int) -> torch.Tensor:
    """``cross_entropy`` of DTensor activations: each rank's terms over
    its own (batch, seq) rows, with the head gathered whole, summed
    across the ranks (``local_sum_mean``)."""
    from torch.distributed.tensor import Replicate
    xl, mesh, pl = _rows_local(x)
    if not is_dtensor(labels):
        labels = placed(labels, mesh, tuple(Replicate() for _ in pl))
    ll = labels.redistribute(mesh, pl).to_local()
    local = {k: gathered(v, pl) for k, v in params.items()
             if k in ("embed", "head")}
    loss = cross_entropy(local, xl, ll, cfg, vocab_chunk)
    return local_sum_mean(loss * ll.numel(), labels.numel(), mesh, pl)
