"""Dense attention model assembly (``repro/models/transformer.py``, the
attention stack only): parameter init, the paged slot cache, and the
full-sequence / decode / chunked-prefill forward paths.

Parameter layout (plain dicts of tensors; ``models/bridge.py`` builds the
same layout from the JAX package's parameter tree):

  {"embed": (Vp, d), "head": (d, Vp) | None (tied), "final_norm": (d,),
   "blocks": [ {"attn": {"wq", "wk", "wv", "wo"}, "ffn": {"w_gate",
                "w_up", "w_down"}, "norm1": (d,), "norm2": (d,)}, ... ]}

Paged cache: {"kv": {"k": (L, NB + 1, bs, K, hd), "v": ...}} — the pool
plus one write-sink block per layer (see models/layers.py).  The
decode and prefill paths update it in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as ly

Params = Dict[str, Any]

ATTN_FAMILIES = ("dense",)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ATTN_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; see ROADMAP Queue 1 "
            f"#12")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random bf16 parameters from a seeded ``torch.Generator`` on the
    target device, at the reference's init scales (the draws differ from
    ``jax.random``'s; use ``models/bridge.py`` for the reference's own
    weights)."""
    _check_family(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff

    def normal(shape, std):
        w = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (w.mul_(std)).to(ly.PDTYPE)

    def zeros(n):
        return torch.zeros((n,), dtype=ly.PDTYPE, device=dev)

    blocks = []
    for _ in range(cfg.num_layers):
        attn = {
            "wq": normal((d, H * hd), 1.0 / math.sqrt(d)),
            "wk": normal((d, K * hd), 1.0 / math.sqrt(d)),
            "wv": normal((d, K * hd), 1.0 / math.sqrt(d)),
            "wo": normal((H * hd, d), 1.0 / math.sqrt(H * hd)),
        }
        if cfg.qkv_bias:
            attn.update(bq=zeros(H * hd), bk=zeros(K * hd), bv=zeros(K * hd))
        blocks.append({
            "attn": attn,
            "ffn": {"w_gate": normal((d, ff), 1.0 / math.sqrt(d)),
                    "w_up": normal((d, ff), 1.0 / math.sqrt(d)),
                    "w_down": normal((ff, d), 1.0 / math.sqrt(ff))},
            "norm1": zeros(d),
            "norm2": zeros(d),
        })
    head = None
    if cfg.sketch.sketched_head:
        raise NotImplementedError("sketched LM head: see ROADMAP Queue 1 #11")
    if not cfg.tie_embeddings:
        head = normal((d, cfg.padded_vocab), 1.0 / math.sqrt(d))
    return {"embed": normal((cfg.padded_vocab, d), 0.02), "head": head,
            "final_norm": zeros(d), "blocks": blocks}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device: DeviceLike = None,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """Shared (L, num_blocks + 1, block_size, K, hd) KV block pool; block
    ``num_blocks`` of each layer is the write sink."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_blocks + 1, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                   "v": torch.zeros(shape, dtype=dtype, device=dev)}}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ffn_residual(p_l: dict, x: torch.Tensor, cfg: ModelConfig):
    h = ly.rms_norm(x, p_l["norm2"], cfg.norm_eps)
    return x + ly.glu_ffn(p_l["ffn"], h, cfg.act)


def forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
            mode: str = "train", cache: Optional[dict] = None,
            index: Optional[torch.Tensor] = None,
            tables: Optional[torch.Tensor] = None,
            kernels: Optional[bool] = None
            ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: embedded inputs (B, S, d).  Returns (final-normed hidden, cache).

    Modes: "train" (full-sequence causal; the test oracle), "decode" (one
    token per slot at per-slot positions ``index`` (B,) through the block
    ``tables`` (B, nb)), "chunk" (a (1, C) prompt chunk of one slot at
    absolute offset ``index`` (1,) through its (1, nb) table row).  The
    paged modes write the cache in place and return it.  ``kernels``:
    paged attention implementation (see kernels/ops.py).
    """
    _check_family(cfg)
    if mode == "train":
        for p_l in params["blocks"]:
            h = ly.rms_norm(x, p_l["norm1"], cfg.norm_eps)
            x = _ffn_residual(p_l, x + ly.causal_attention(p_l["attn"], h,
                                                           cfg), cfg)
        return ly.rms_norm(x, params["final_norm"], cfg.norm_eps), None
    if mode not in ("decode", "chunk"):
        raise ValueError(f"mode {mode!r} is not ported (train / decode / "
                         f"chunk)")
    B, S, _ = x.shape
    positions = index[:, None] + torch.arange(S, dtype=torch.int32,
                                              device=x.device)
    # nothing is folded on this path: the exact span starts at 0
    fold_base = torch.zeros((B,), dtype=torch.int32, device=x.device)
    kv = cache["kv"]
    for i, p_l in enumerate(params["blocks"]):
        h = ly.rms_norm(x, p_l["norm1"], cfg.norm_eps)
        a = ly.paged_self_attention(p_l["attn"], h, cfg, kv["k"][i],
                                    kv["v"][i], positions, tables,
                                    fold_base, kernels)
        x = _ffn_residual(p_l, x + a, cfg)
    return ly.rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def embed_inputs(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return ly.embed_tokens(params["embed"], tokens)


def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                index: torch.Tensor, cfg: ModelConfig,
                tables: torch.Tensor, kernels: Optional[bool] = None
                ) -> Tuple[torch.Tensor, dict]:
    """tokens: (B, 1) int; index: (B,) int32 positions; tables: (B, nb)
    int32.  Returns (logits (B, Vp) f32, cache updated in place)."""
    x = embed_inputs(params, tokens)
    y, cache = forward(params, x, cfg, mode="decode", cache=cache,
                       index=index.to(torch.int32), tables=tables,
                       kernels=kernels)
    return ly.logits_fn(params, y, cfg)[:, 0], cache


def prefill_chunk(params: Params, cache: dict, tokens: torch.Tensor,
                  table: torch.Tensor, start, cfg: ModelConfig,
                  kernels: Optional[bool] = None) -> dict:
    """Chunked prefill step: write KV rows for absolute positions
    [start, start + C) into the pool through the slot's
    (blocks_per_slot,) block-table row, attending the chunk against
    everything the table already references below it.  tokens: (1, C);
    start: int or (1,) int32.  No logits: decode resumes at the last
    prompt position and recomputes that row."""
    dev = tokens.device
    # a fill, not a host-to-device copy: no wait on the stream
    st = (start.to(device=dev, dtype=torch.int32).reshape(1)
          if torch.is_tensor(start)
          else torch.full((1,), start, dtype=torch.int32, device=dev))
    tbl = table.to(device=dev, dtype=torch.int32).reshape(1, -1)
    _, cache = forward(params, embed_inputs(params, tokens), cfg,
                       mode="chunk", cache=cache, index=st, tables=tbl,
                       kernels=kernels)
    return cache
