"""Draft derivation for speculative decoding (port of
``repro/models/draft.py``).

The speculative engine needs a proposer much cheaper than the served
model that agrees with it often.  Two derivations, composable:

  * truncation (``draft_depth``): the first ``depth`` layers of the
    block stack, sharing the embedding, final norm and LM head.  The
    port keeps one dict per layer, so truncation is ``blocks[:depth]``
    (the same tensors, not copies).
  * count-sketch compression (``draft_sketch_ratio`` > 0): every block
    matrix W (d_in, d_out) is replaced by its count-sketch reconstruction
    along the contraction dim, median_r S_r^T S_r W, with the hash family
    of ``sketch/hashing.py``, and the LM head by the FCS-sketched head of
    ``models/layers.py`` (paper Section 4.2) at the same ratio.  The
    sketch and the reconstruction are the ``count_sketch`` and
    ``unsketch`` ops (``kernels/ops.py``): on the card the hand-written
    kernels, one launch each per layer matrix.  The moe family's leaves
    follow the reference's flatten of its stacked (L, E, d, f) leaves:
    each expert slice of ``moe/we_gate`` / ``we_up`` / ``we_down`` is a
    matrix of its own under seed ``leaf_seed + layer * E + expert``; the
    router (d, E) is reconstructed in f32 and stays f32, and the shared
    experts ``moe/ws_*`` are matrices of the layer like the attention's.
    The 1-D leaves (norms, the attention biases ``bq`` / ``bk`` /
    ``bv``) pass through as the target's tensors.

Either way the draft is a params dict and a ``ModelConfig`` that run
through the unchanged ``transformer`` decode / prefill paths; the
scheduler gives it its own shallow paged pool on the target's block
tables.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as ly
from repro_torch.models import transformer as tf
from repro_torch.sketch.csvec import median_rows
from repro_torch.sketch.hashing import cached_coeffs, row_buckets_signs

class Draft(NamedTuple):
    """A derived proposer: params and the config that interprets them."""
    params: Any
    cfg: ModelConfig


def truncate_params(params: Any, cfg: ModelConfig, depth: int):
    """Shallow draft: the first ``depth`` layers with the shared embed,
    final norm and head.  Returns (draft_params, draft_cfg)."""
    if cfg.family not in tf.ATTN_FAMILIES:
        raise ValueError(f"draft truncation needs an attention family, "
                         f"got {cfg.family!r}")
    depth = int(depth)
    if not 1 <= depth <= cfg.num_layers:
        raise ValueError(f"draft_depth {depth} outside [1, {cfg.num_layers}]")
    dcfg = dataclasses.replace(cfg, num_layers=depth)
    return {**params, "blocks": list(params["blocks"][:depth])}, dcfg


def _cs_reconstruct(w: torch.Tensor, ratio: int, rows: int,
                    seed: int) -> torch.Tensor:
    """Count-sketch a (d_in, d_out) matrix along d_in into
    J = d_in // ratio buckets under ``rows`` hash rows and reconstruct:
    the median over rows of S_r^T (S_r W), in w's dtype.  The sketch is
    ``count_sketch_op`` of W^T's d_out rows, f32 -> (rows, d_out, J); the
    reconstruction ``unsketch_op`` -> (rows, d_out, d_in)."""
    d_in = w.shape[0]
    J = max(1, d_in // max(1, ratio))
    if J >= d_in:
        return w
    coeffs = cached_coeffs(seed, rows, device=w.device)
    idx = torch.arange(d_in, dtype=torch.int64, device=w.device)
    bk, sg = row_buckets_signs(coeffs, idx, J, signed=True)
    wt = w.t().float().contiguous()                       # (d_out, d_in)
    table = kops.count_sketch_op(wt, bk, sg, J)           # (rows, d_out, J)
    del wt
    est = kops.unsketch_op(table, bk, sg)                 # (rows, d_out, d_in)
    del table
    return median_rows(est).t().to(w.dtype).contiguous()


def leaf_seed(name: str, base_seed: int) -> int:
    """The reference's per-leaf hash seed for the stacked leaf ``name``
    ("attn/wq", "ffn/w_down", ...); layer i adds i."""
    return (base_seed * 1_000_003 + zlib.crc32(name.encode())) & 0x7FFFFFFF


def block_matrices(block: dict):
    """(leaf path, tensor) of a layer's matrix leaves — 2-D (d_in, d_out)
    matrices and the moe family's 3-D (E, d_in, d_out) expert stacks —
    in the reference's flatten order of the stacked block tree (sorted
    keys); the per-layer 1-D leaves (norms, biases) are left out: they
    pass through."""
    out = []
    for k in sorted(block):
        v = block[k]
        if isinstance(v, dict):
            out.extend((f"{k}/{kk}", v[kk]) for kk in sorted(v)
                       if v[kk].ndim >= 2)
        elif v.ndim >= 2:
            out.append((k, v))
    return out


def _compress_block(block: dict, layer: int, ratio: int, rows: int,
                    base_seed: int) -> dict:
    """One layer with every matrix count-sketch reconstructed, each under
    the seed of its leaf and slice, as the reference's ``_compress_leaf``
    seeds slice i of a stacked leaf flattened to (lead, d_in, d_out):
    ``layer`` for a (L, d_in, d_out) leaf, ``layer * E + e`` for expert
    e of a (L, E, d_in, d_out) one."""
    new = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in block.items()}
    for name, w in block_matrices(block):
        seed = leaf_seed(name, base_seed)
        if w.ndim == 2:
            rec = _cs_reconstruct(w, ratio, rows, seed + layer)
        else:
            E = w.shape[0]
            rec = torch.stack([
                _cs_reconstruct(w[e], ratio, rows, seed + layer * E + e)
                for e in range(E)])
        if "/" in name:
            a, b = name.split("/")
            new[a][b] = rec
        else:
            new[name] = rec
        # one leaf's (rows, d_out, d_in) f32 reconstruction is the
        # derivation's peak: at gemma-2b's w_gate 403 MB
        del rec
    return new


def sketch_head(params: Any, cfg: ModelConfig, J: int,
                seed: int) -> torch.Tensor:
    """The (J, Vp) FCS-sketched head derived from the dense head (or the
    tied embedding): head_sk[j] = sum_{h(d) = j} sg(d) W[d], the
    counterpart of the activation sketch ``layers._head_io`` applies, so
    logits ~= x W at CR = d_model / J.  It is the count sketch of W^T's
    Vp rows (``count_sketch_op``, f32 accumulation), transposed."""
    if params.get("head") is not None:
        wt = params["head"].t().contiguous()                  # (Vp, d)
    else:
        wt = params["embed"]
    h, sg, links = ly.head_hash(seed, cfg.d_model, J, wt.device)
    hs = kops.count_sketch_op(wt, h, sg, J, index=links)      # (Vp, J)
    return hs.t().contiguous().to(ly.PDTYPE)


def compress_params(params: Any, cfg: ModelConfig, depth: int,
                    ratio: int, rows: int = 3,
                    seed: Optional[int] = None):
    """Count-sketch-compressed draft: truncate to ``depth`` layers,
    reconstruct every block matrix through a ratio-J count sketch, and
    replace the head with the sketched head at the same ratio.  Returns
    (draft_params, draft_cfg); ``ratio <= 1`` is pure truncation."""
    dparams, dcfg = truncate_params(params, cfg, depth)
    if ratio <= 1:
        return dparams, dcfg
    seed = cfg.sketch.seed if seed is None else seed
    with torch.no_grad():
        blocks = [_compress_block(b, i, ratio, rows, seed)
                  for i, b in enumerate(dparams["blocks"])]
        J = max(1, cfg.d_model // ratio)
        head = sketch_head(params, cfg, J, seed)
    dcfg = dataclasses.replace(
        dcfg, tie_embeddings=False,
        sketch=dataclasses.replace(cfg.sketch, sketched_head=True,
                                   head_hash_len=J, seed=seed))
    return {**dparams, "blocks": blocks, "head": head}, dcfg


def make_draft(params: Any, cfg: ModelConfig,
               serve: Optional[ServeConfig] = None) -> Optional[Draft]:
    """The draft the serve config asks for: None when speculation is off
    (``spec_k == 0``) or the family has no KV cache to verify against;
    else a ``draft_depth``-layer truncation, count-sketch-compressed when
    ``draft_sketch_ratio > 0``."""
    sv = serve if serve is not None else cfg.serve
    if sv.spec_k <= 0 or cfg.family not in tf.ATTN_FAMILIES:
        return None
    depth = min(max(1, sv.draft_depth), cfg.num_layers)
    dparams, dcfg = compress_params(params, cfg, depth,
                                    sv.draft_sketch_ratio)
    return Draft(params=dparams, cfg=dcfg)
