"""Shared layers of the port (``repro/models/layers.py``): norms, RoPE,
GQA/MQA attention over the paged KV pool (decode and chunked prefill),
full-sequence causal attention (the training path), the GLU FFN,
embeddings, the LM head and the training loss.

Plain functions over explicit parameter dicts.  Weights are bf16;
norms, softmax statistics and logits are f32.

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

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

PDTYPE = torch.bfloat16  # parameter dtype


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
                      positions: torch.Tensor):
    """Project (+bias), split heads, rope q and k at ``positions``
    ((S,) or (B, S)).  Shared by decode and chunked prefill, so a prompt
    row prefilled in a chunk and recomputed by decode is bit-identical."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    q = x @ p["wq"]
    kn = x @ p["wk"]
    vn = x @ p["wv"]
    if cfg.qkv_bias:
        q, kn, vn = q + p["bq"], kn + p["bk"], vn + p["bv"]
    q = rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    kn = rope(kn.reshape(B, S, K, hd), positions, cfg.rope_theta)
    return q, kn, vn.reshape(B, S, K, hd)


def paged_attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 tables: torch.Tensor, start: torch.Tensor,
                 fold_base: torch.Tensor,
                 use_kernel: Optional[bool]) -> torch.Tensor:
    """Attend straight through the block tables (the reference's
    ``_kernel_paged_attention``).  qg: (B, Sq, K, R, hd); k/v: the
    (NB, bs, K, hd) pools; start: (B,) position of each slot's query
    row 0.  Returns (B, Sq, K, R, hd) in qg's dtype."""
    _, l, acc = kops.paged_attention_op(qg, k, v, tables, start, fold_base,
                                        use_kernel=use_kernel)
    o = acc / torch.clamp(l, min=1e-30)[..., None]      # (B,K,R,Sq,hd)
    return o.permute(0, 3, 1, 2, 4).to(qg.dtype)


def paged_self_attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
                         pool_k: torch.Tensor, pool_v: torch.Tensor,
                         positions: torch.Tensor, tables: torch.Tensor,
                         fold_base: torch.Tensor,
                         use_kernel: Optional[bool] = None
                         ) -> torch.Tensor:
    """Attention of new rows against the paged pool — the reference's
    ``_paged_decode_attention`` (one token per slot, x (B, 1, d),
    positions (B, 1)) and ``chunk_attention`` (one prompt chunk of one
    slot, x (1, C, d), positions (1, C) = start + arange(C)) in one.
    Each new KV row scatters through its slot's (B, nb) block-table row
    into the layer's pool in place (the JAX version donated the pool);
    rows on unallocated entries (== NB) or past the table land in the
    write sink, so an idle slot or a tail chunk's padding mutates no live
    block.  Then query i of slot b attends causally — key p visible iff
    ``fold_base[b] <= p <= positions[b, i]`` — through the tables, so a
    chunk sees earlier chunks and shared prefix blocks.  Pools are
    (NB + 1, bs, K, hd) with the sink last.  Returns (B, S, d)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    NB, bs = pool_k.shape[0] - 1, pool_k.shape[1]
    nb_slot = tables.shape[1]
    q, kn, vn = _project_qkv_rope(p, x, cfg, positions)
    blk = torch.div(positions, bs, rounding_mode="floor").long()
    phys = torch.gather(tables, 1, blk.clamp(max=nb_slot - 1))
    phys = torch.where(blk < nb_slot, phys, NB).long()
    off = (positions % bs).long()
    pool_k.index_put_((phys, off), kn.to(pool_k.dtype))
    pool_v.index_put_((phys, off), vn.to(pool_v.dtype))
    qg = q.reshape(B, S, K, H // K, hd)
    o = paged_attend(qg, pool_k[:NB], pool_v[:NB], tables,
                     positions[:, 0].contiguous(), fold_base, use_kernel)
    return o.reshape(B, S, H * hd) @ p["wo"]


def causal_attention(p: dict, x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence causal attention of ``forward(mode="train")``: the
    training path's attention, differentiated by autograd.  f32 scores and
    one softmax over all keys; the reference's ``causal_attention`` walks
    KV chunks of 1024 with an online softmax, the same function (one chunk
    at the training path's sequence lengths).  x: (B, S, d)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv_rope(p, x, cfg, positions)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, -1e30)
    pr = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, v)
    return o.reshape(B, S, H * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# GLU FFN, embedding, LM head
# ---------------------------------------------------------------------------


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if name == "gelu" else F.silu(x)


def glu_ffn(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (_act(act, g) * u) @ p["w_down"]


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return emb[tokens]


def _head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """The (d, Vp) vocab projection: the dense head or the tied embed."""
    if cfg.sketch.sketched_head:
        raise NotImplementedError(
            "the FCS-sketched LM head is not ported yet; see ROADMAP "
            "Queue 1 #11")
    return params["head"] if params.get("head") is not None \
        else params["embed"].t()


def logits_fn(params: dict, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Final hidden -> vocab logits (f32), dense or tied head."""
    return (x @ _head(params, cfg)).float()


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
    ``cross_entropy``): a vocab-chunked online logsumexp, each chunk
    recomputed in the backward, so the (B, S, V) f32 logits never exist
    whole.  The logsumexp runs over all ``padded_vocab`` columns of the
    head (padded rows carry init weights, as in the reference).  The
    reference pads the head to a whole number of chunks and masks the
    padding; here the last chunk is narrower, which is the same sum."""
    head = _head(params, cfg)
    B, S, _ = x.shape
    V = head.shape[-1]
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    gold = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for c0 in range(0, V, vocab_chunk):
        m, l, gold = checkpoint(_ce_chunk, x, head[:, c0:c0 + vocab_chunk],
                                labels, c0, m, l, gold, use_reentrant=False)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return (lse - gold).mean()
