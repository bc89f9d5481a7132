"""Model assembly (``repro/models/transformer.py``): parameter init,
slot caches, the full-sequence (training) / prefill / decode / verify /
chunked-prefill forward paths and the training loss, for the attention
stack of the dense, moe, audio and vlm families and for the recurrent
families, ssm (xLSTM: groups of mLSTM blocks then sLSTM blocks) and
hybrid (Zamba2: groups of Mamba-2 blocks, each followed by one of the
shared attention blocks, round-robin; models/ssm.py).  The audio and vlm
families are the dense stack behind a frontend stub whose precomputed
embeddings only their training batches carry; they serve token ids like
the dense family.

Parameter layout (plain dicts of tensors; ``models/bridge.py`` builds the
same layout from the JAX package's parameter tree):

  {"embed": (Vp, d), "head": (d, Vp) | (J, Vp) (FCS-sketched head,
   models/layers.py:_head_io) | None (tied), "final_norm": (d,),
   "blocks": [ {"attn": {"wq", "wk", "wv", "wo"[, "bq", "bk", "bv"]},
                "ffn": {"w_gate", "w_up", "w_down"} (the moe family:
                "moe": models/moe.py:init_moe), "norm1": (d,),
                "norm2": (d,)}, ... ]}

and for the recurrent families "blocks" is a dict of per-layer lists:
{"mlstm": [...], "slstm": [...]} (ssm) or {"mamba": [...], "shared":
[ {"attn", "ffn", "norm1", "norm2"}, ... ]} (hybrid).

The reference stacks every block parameter as one (L, ...) leaf; the
port keeps L per-layer tensors.  ``param_leaves`` lists the reference's
leaves in its flatten order (sorted keys; a tied ``None`` head drops out)
with each stacked leaf as its L per-layer pieces — the order and grouping
the optimizers' state follows.

Paged cache (attention families): {"kv": {"k": (L, NB + 1, bs, K, hd),
"v": ...}} — the pool plus one write-sink block per layer (see
models/layers.py) — and, for a sketched long-context engine, "tail": the
(2, L, B, Z, C, K, hd) f32 FCS tail tables (serve/kv_sketch.py).  The
decode and prefill paths update the pool in place and only read the
tail.

Slot cache of the recurrent families (``init_cache``), as the
reference's: ssm {"mlstm": {"C", "n", "m", "conv"}, "slstm": {"c", "n",
"h", "m"}}, hybrid {"mamba": {"ssm", "conv_x", "conv_BC"}, "shared_kv":
{"k", "v"}: (G, B, max_seq, K, hd), one dense cache per group}, every
leaf stacked on a leading layer (or group) axis.  ``decode_step``
advances it in place; ``prefill`` returns a new one of batch B whose
shared KV holds the prompt's S rows.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as ly
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.sharding import shard

Params = Dict[str, Any]

ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")
RECURRENT_FAMILIES = ("ssm", "hybrid")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to the tensor leaves of nested dicts and lists (and of
    trees of the same structure in ``rest``); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def param_leaves(params: Params) -> List[Tuple[str, List[torch.Tensor]]]:
    """The reference's parameter leaves in ``jax.tree.flatten`` order, each
    as (path, pieces): a stacked block leaf ("blocks/attn/wq") has its L
    per-layer tensors as pieces, a top-level leaf itself.  Works on any
    tree shaped like the params (gradients, dense moments).  The walk is
    module-level recursion: a recursive closure would make a reference
    cycle holding every leaf (a step's gradients) until the cyclic
    collector ran."""
    out: List[Tuple[str, List[torch.Tensor]]] = []
    for k in sorted(params):
        if k != "blocks":
            _walk_leaves(params[k], k, out)
        elif isinstance(params[k], dict):        # the recurrent families
            for kk in sorted(params[k]):
                _stacked_leaves(params[k][kk], f"blocks/{kk}", out)
        else:
            _stacked_leaves(params[k], "blocks", out)
    return out


def _walk_leaves(node: Any, path: str, out: list) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk_leaves(node[k], f"{path}/{k}" if path else k, out)
    else:
        out.append((path, [node]))


def _stacked_leaves(nodes: List[Any], path: str, out: list) -> None:
    if isinstance(nodes[0], dict):
        for kk in sorted(nodes[0]):
            _stacked_leaves([n[kk] for n in nodes], f"{path}/{kk}", out)
    else:
        out.append((path, list(nodes)))


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ATTN_FAMILIES + RECURRENT_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def _paged_family(cfg: ModelConfig) -> None:
    if cfg.family not in ATTN_FAMILIES:
        raise ValueError(f"paged KV needs an attention family, got "
                         f"{cfg.family!r}")


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
    g = None
    if dev.type != "meta":      # "meta": shapes and dtypes, no storage
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff

    def normal(shape, std, dtype=ly.PDTYPE):
        w = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return (w.mul_(std)).to(dtype)

    def uniform(shape):
        return torch.rand(shape, generator=g, device=dev,
                          dtype=torch.float32)

    def zeros(n):
        return torch.zeros((n,), dtype=ly.PDTYPE, device=dev)

    def attn_block():
        attn = {
            "wq": normal((d, H * hd), 1.0 / math.sqrt(d)),
            "wk": normal((d, K * hd), 1.0 / math.sqrt(d)),
            "wv": normal((d, K * hd), 1.0 / math.sqrt(d)),
            "wo": normal((H * hd, d), 1.0 / math.sqrt(H * hd)),
        }
        if cfg.qkv_bias:
            attn.update(bq=zeros(H * hd), bk=zeros(K * hd), bv=zeros(K * hd))
        blk = {"attn": attn, "norm1": zeros(d), "norm2": zeros(d)}
        if cfg.family == "moe":
            blk["moe"] = moe.init_moe(cfg, normal)
        else:
            blk["ffn"] = {"w_gate": normal((d, ff), 1.0 / math.sqrt(d)),
                          "w_up": normal((d, ff), 1.0 / math.sqrt(d)),
                          "w_down": normal((ff, d), 1.0 / math.sqrt(ff))}
        return blk

    if cfg.family == "ssm":
        n_m, n_s = _xlstm_counts(cfg)
        blocks: Any = {
            "mlstm": [ssm.init_mlstm(cfg, normal, dev) for _ in range(n_m)],
            "slstm": [ssm.init_slstm(cfg, normal, dev) for _ in range(n_s)]}
    elif cfg.family == "hybrid":
        blocks = {"mamba": [ssm.init_mamba2(cfg, normal, uniform, dev)
                            for _ in range(cfg.num_layers)],
                  "shared": [attn_block() for _ in
                             range(cfg.hybrid.num_shared_blocks)]}
    else:
        blocks = [attn_block() for _ in range(cfg.num_layers)]
    head = None
    if cfg.sketch.sketched_head:
        # the projection lives in the J-dim sketch space (paper Section
        # 4.2); it takes precedence over tied embeddings, as in the
        # reference's init_head
        J = ly.head_sketch_len(cfg)
        head = normal((J, cfg.padded_vocab), 1.0 / math.sqrt(J))
    elif not cfg.tie_embeddings:
        head = normal((d, cfg.padded_vocab), 1.0 / math.sqrt(d))
    return {"embed": normal((cfg.padded_vocab, d), 0.02), "head": head,
            "final_norm": zeros(d), "blocks": blocks}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device: DeviceLike = None,
                     dtype: torch.dtype = torch.bfloat16,
                     tail: Optional[Tuple[int, int, int]] = None) -> dict:
    """Shared (L, num_blocks + 1, block_size, K, hd) KV block pool; block
    ``num_blocks`` of each layer is the write sink.  ``tail`` = (batch,
    rows, cols) adds the zeroed FCS tail tables of a sketched engine."""
    _paged_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_blocks + 1, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    cache = {"kv": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}}
    if tail is not None:
        from repro_torch.serve import kv_sketch as kvs
        cache["tail"] = kvs.init_tail(cfg, *tail, device=dev)
    return cache


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ffn_residual(p_l: dict, x: torch.Tensor, cfg: ModelConfig,
                  live: Optional[Tuple[int, int]] = None, layer: int = 0,
                  positions: Optional[torch.Tensor] = None,
                  slab: Optional[int] = None):
    """x plus the block's FFN (GLU, or MoE for the moe family) of its
    norm.  x is (B, S, d), or (rows, d) holding the B*S rows of ``live``
    = (B, S) first and zero padding after (the paged paths' layout).
    The MoE routes only those B*S rows, in (B, S) order: the padding
    would change the group size, and its zero rows, tied across every
    expert, would all pick the first K experts and fill their capacity;
    the padding rows' output stays zero.  ``slab`` (the decode and
    verify steps' step rows): the norm, the GLU and the MoE's router and
    shared experts run over slabs of that many rows (models/layers.py,
    row padding).  ``layer`` and ``positions`` ((B, S)) reach the MoE's
    routing probe (models/moe.py)."""
    h = ly.by_slabs(lambda t: ly.rms_norm(t, p_l["norm2"], cfg.norm_eps),
                    x, slab)
    if cfg.family != "moe":
        return x + ly.by_slabs(lambda t: ly.glu_ffn(p_l["ffn"], t, cfg.act),
                               h, slab)
    return x + moe.moe_ffn(p_l["moe"], h, cfg, layer, positions, live=live,
                           slab=slab)


def _train_block(p_l: dict, x: torch.Tensor, cfg: ModelConfig,
                 layer: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention block of the training forward: (x after the block,
    the block's aux loss: the router's for the moe family, else 0)."""
    h = ly.rms_norm(x, p_l["norm1"], cfg.norm_eps)
    x = x + ly.causal_attention(p_l["attn"], h, cfg)
    if cfg.family != "moe":
        return _ffn_residual(p_l, x, cfg), x.new_zeros((), dtype=torch.float32)
    f, aux = moe.moe_ffn(p_l["moe"], ly.rms_norm(x, p_l["norm2"],
                                                 cfg.norm_eps),
                         cfg, layer, with_aux=True)
    return x + f, aux


def _train_forward(params: Params, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (final-normed hidden, summed aux loss f32).
    Every block runs under ``checkpoint``, its activations recomputed in
    the backward, as the reference's ``jax.checkpoint`` over its layer
    scans.  The aux loss leaves each attention block as an output of its
    checkpointed body, beside x: a value appended from inside the body
    would be appended again when the backward recomputes it."""
    aux = x.new_zeros((), dtype=torch.float32)
    x = shard(x, "batch", "residual", None)
    if cfg.family in RECURRENT_FAMILIES:
        run = _forward_xlstm if cfg.family == "ssm" else _forward_zamba
        x, _ = run(params, x, cfg, "train", None, None)
    else:
        for i, p_l in enumerate(params["blocks"]):
            x, a = checkpoint(_train_block, p_l, x, cfg, i,
                              use_reentrant=False)
            x = shard(x, "batch", "residual", None)
            aux = aux + a
    return ly.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
            mode: str = "train", cache: Optional[dict] = None,
            index: Optional[torch.Tensor] = None,
            tables: Optional[torch.Tensor] = None,
            kernels: Optional[bool] = None,
            sketch: Optional[dict] = None, rows: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: embedded inputs (B, S, d).  Returns (final-normed hidden, cache).

    Modes: "train" (full-sequence causal; each block's activations are
    recomputed in the backward, as the reference's
    ``jax.checkpoint(nothing_saveable)`` over the layer scan; the moe
    family's aux loss is ``loss_fn``'s, see ``_train_forward``), "decode" (one
    token per slot at per-slot positions ``index`` (B,) through the block
    ``tables`` (B, nb)), "verify" (S consecutive tokens per slot from
    ``index``: the speculative verify step), "chunk" (a (1, C) prompt
    chunk of one slot at absolute offset ``index`` (1,) through its
    (1, nb) table row).  The paged modes write the cache in place and
    return it.  ``kernels``: paged attention implementation (see
    kernels/ops.py).

    ``sketch`` (paged modes only): two-span long-context attention
    against FCS tail tables (serve/kv_sketch.py): {"fold_base": (B,)
    int32, "tail": (2, L, B, Z, C, K, hd) tables of these B slots,
    "coeffs": (Z, 4) hash coefficients, "pos_hash": the (Z, T) position
    buckets and signs of ``kv_sketch.pos_buckets_signs``}.  Without it
    nothing is folded and the exact span starts at 0.  With a DTensor
    pool the tails are DTensors too, split by bucket columns over the
    rules' ``kv_blocks`` (models/model.py:tail_sketch builds the state;
    models/layers.py runs each rank's two spans).

    ``rows`` (paged modes only): the step rows: run the B*S rows padded
    with zero rows to a whole number of ``rows``-row slabs, every GEMM
    and row reduction one slab at a time (models/layers.py, row
    padding).

    The recurrent families run "train" (the full sequence from a zero
    state), "prefill" (the same, returning the state after the last token
    as a new cache of x's batch) and "decode" (one token per slot at
    positions ``index`` (B,), advancing ``cache`` (``init_cache``) in
    place and returning it).
    """
    _check_family(cfg)
    if mode == "train":
        return _train_forward(params, x, cfg)[0], None
    if cfg.family in RECURRENT_FAMILIES:
        if mode not in ("prefill", "decode"):
            raise ValueError(f"mode {mode!r} needs a kv-cache family, got "
                             f"{cfg.family!r}")
        run = _forward_xlstm if cfg.family == "ssm" else _forward_zamba
        y, new_cache = run(params, x, cfg, mode, cache, index)
        return ly.rms_norm(y, params["final_norm"], cfg.norm_eps), new_cache
    if mode not in ("decode", "verify", "chunk"):
        raise ValueError(f"mode {mode!r} is not ported (train / decode / "
                         f"verify / chunk)")
    B, S, d = x.shape
    y = _paged_forward(params, x, cfg, cache, index, tables, kernels, sketch,
                       rows)
    if y.shape[0] != B * S:                     # row padding
        y = y[:B * S]
    return y.reshape(B, S, d), cache


def _paged_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   cache: dict, index: torch.Tensor, tables: torch.Tensor,
                   kernels: Optional[bool], sketch: Optional[dict],
                   rows: Optional[int] = None) -> torch.Tensor:
    """The paged modes of ``forward`` on the B*S rows of x, padded with
    zero rows to whole slabs of ``rows`` rows when given, the row ops
    running slab by slab (models/layers.py, row padding): returns the
    final-normed hidden rows in that padded (n rows, d) layout."""
    B, S, d = x.shape
    positions = index[:, None] + torch.arange(S, dtype=torch.int32,
                                              device=x.device)
    if sketch is None:
        fold_base = torch.zeros((B,), dtype=torch.int32, device=x.device)
    else:
        fold_base = sketch["fold_base"]
    kv = cache["kv"]
    # the paged paths run rows of (B, S): a context-sharded sequence is
    # gathered (no split of a slot's rows over ranks)
    h = shard(x, "batch", None, None).reshape(B * S, d)
    if rows is not None:
        h = ly.pad_rows(h, ly.slab_rows(B * S, rows))
    for i, p_l in enumerate(params["blocks"]):
        a = ly.by_slabs(lambda t: ly.rms_norm(t, p_l["norm1"], cfg.norm_eps),
                        h, rows)
        tail = (None if sketch is None
                else (sketch["tail"][0, i], sketch["tail"][1, i]))
        a = ly.paged_self_attention(p_l["attn"], a, cfg, kv["k"][i],
                                    kv["v"][i], positions, tables,
                                    fold_base, kernels, tail, sketch, rows)
        h = _ffn_residual(p_l, h + a, cfg, (B, S), i, positions, rows)
        h = shard(h, "batch", None)
    return ly.by_slabs(lambda t: ly.rms_norm(t, params["final_norm"],
                                             cfg.norm_eps), h, rows)


def _xlstm_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(mLSTM, sLSTM) layer counts of an xLSTM config."""
    xl = cfg.xlstm
    G = cfg.num_layers // (xl.m_per_group + xl.s_per_group)
    return G * xl.m_per_group, G * xl.s_per_group


def _stack_states(states: List[dict]) -> dict:
    """Per-layer states -> one state whose leaves stack them on axis 0."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _forward_xlstm(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   mode: str, cache: Optional[dict],
                   index: Optional[torch.Tensor]):
    """xLSTM[m:s]: each group runs its m_per_group mLSTM blocks, then its
    s_per_group sLSTM blocks, each a residual branch (in "train" mode each
    under ``checkpoint``, as the reference's ``jax.checkpoint`` per
    block).  Returns (hidden before the final norm, cache)."""
    xl = cfg.xlstm
    m_per, s_per = xl.m_per_group, xl.s_per_group
    blocks = params["blocks"]
    want = mode == "prefill"
    decode = mode == "decode"
    states: Dict[str, List[dict]] = {"mlstm": [], "slstm": []}
    h = x
    for g in range(cfg.num_layers // (m_per + s_per)):
        for kind, n, block in (("mlstm", m_per, ssm.mlstm_block),
                               ("slstm", s_per, ssm.slstm_block)):
            for i in range(g * n, (g + 1) * n):
                if mode == "train":
                    h = checkpoint(_residual, block, blocks[kind][i], h, cfg,
                                   use_reentrant=False)
                    continue
                st = ssm.layer_view(cache[kind], i) if decode else None
                out, ns = block(blocks[kind][i], h, cfg, state=st,
                                want_state=want)
                h = h + out
                if want:
                    states[kind].append(ns)
        if not decode:
            h = shard(h, "batch", "residual", None)
    if want:
        return h, {k: _stack_states(v) for k, v in states.items()}
    return h, cache if decode else None


def _residual(block: Callable, p: dict, h: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """h plus a recurrent block's full-sequence output from a zero state:
    the body the training forward checkpoints per block."""
    return h + block(p, h, cfg)[0]


def _shared_block(p_s: dict, h: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """A zamba2 shared block on the full sequence (attention, then the GLU
    FFN, each a residual branch): the training forward's checkpointed
    body."""
    a = ly.causal_attention(p_s["attn"], ly.rms_norm(h, p_s["norm1"],
                                                     cfg.norm_eps), cfg)
    return _ffn_residual(p_s, h + a, cfg)


def _forward_zamba(params: Params, x: torch.Tensor, cfg: ModelConfig,
                   mode: str, cache: Optional[dict],
                   index: Optional[torch.Tensor]):
    """Zamba2: group g runs its mamba_per_group Mamba-2 blocks, then the
    shared block g % num_shared_blocks (attention and GLU FFN, each a
    residual branch) against group g's own KV cache.  In "train" mode
    each Mamba-2 block and each shared block's application runs under
    ``checkpoint``, as in the reference.  Returns (hidden before the
    final norm, cache)."""
    hb = cfg.hybrid
    per = hb.mamba_per_group
    blocks = params["blocks"]
    want = mode == "prefill"
    decode = mode == "decode"
    mamba: List[dict] = []
    kv: Dict[str, List[torch.Tensor]] = {"k": [], "v": []}
    positions = torch.arange(x.shape[1], device=x.device)
    h = x
    for g in range(cfg.num_layers // per):
        p_s = blocks["shared"][g % hb.num_shared_blocks]
        if mode == "train":
            for i in range(g * per, (g + 1) * per):
                h = checkpoint(_residual, ssm.mamba2_block,
                               blocks["mamba"][i], h, cfg,
                               use_reentrant=False)
            h = checkpoint(_shared_block, p_s, h, cfg, use_reentrant=False)
            h = shard(h, "batch", "residual", None)
            continue
        for i in range(g * per, (g + 1) * per):
            st = ssm.layer_view(cache["mamba"], i) if decode else None
            out, ns = ssm.mamba2_block(blocks["mamba"][i], h, cfg, state=st,
                                       want_state=want)
            h = h + out
            if want:
                mamba.append(ns)
        a_in = ly.rms_norm(h, p_s["norm1"], cfg.norm_eps)
        if decode:
            a = ly.dense_decode_attention(
                p_s["attn"], a_in, cfg, cache["shared_kv"]["k"][g],
                cache["shared_kv"]["v"][g], index)
        else:
            a = ly.causal_attention(p_s["attn"], a_in, cfg)
            if want:
                # the prompt's roped K and V rows for the decode cache
                _, k, v = ly._project_qkv_rope(p_s["attn"], a_in, cfg,
                                               positions)
                kv["k"].append(k)
                kv["v"].append(v)
        h = _ffn_residual(p_s, h + a, cfg)
        if not decode:
            h = shard(h, "batch", "residual", None)
    if want:
        return h, {"mamba": _stack_states(mamba),
                   "shared_kv": {k: torch.stack(v) for k, v in kv.items()}}
    return h, cache if decode else None


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """The zero slot cache of a recurrent family (see the module
    docstring): ``batch`` slots, every leaf stacked on a leading layer
    (or group) axis; the hybrid family's shared KV holds ``max_seq`` rows
    a slot.  The attention families' slot cache is ``init_paged_cache``."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        n_m, n_s = _xlstm_counts(cfg)
        return {"mlstm": ssm.init_mlstm_state(cfg, n_m, batch, dev, dtype),
                "slstm": ssm.init_slstm_state(cfg, n_s, batch, dev)}
    if cfg.family == "hybrid":
        G = cfg.num_layers // cfg.hybrid.mamba_per_group
        return {"mamba": ssm.init_mamba2_state(cfg, cfg.num_layers, batch,
                                               dev, dtype),
                "shared_kv": ly.init_kv_cache(cfg, G, batch, max_seq, dev,
                                              dtype)}
    raise ValueError(f"init_cache builds a recurrent family's slot state; "
                     f"{cfg.family!r} uses init_paged_cache")


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence prefill of a recurrent family: tokens (B, S) ->
    (last-token logits (B, Vp) f32, the cache after the last token, a new
    one of batch B; the hybrid family's shared KV holds the S rows)."""
    y, cache = forward(params, embed_inputs(params, tokens), cfg,
                       mode="prefill")
    return ly.logits_fn(params, y[:, -1:], cfg)[:, 0], cache


def embed_inputs(params: Params, batch) -> torch.Tensor:
    """The model's (B, S, d) inputs: a batch's precomputed frontend
    embeddings ("embeds", the audio and vlm families' training batches),
    cast to bf16, or the embedding rows of its token ids ("tokens"; or
    of ``batch`` itself, a (B, S) token tensor)."""
    if isinstance(batch, dict):
        if "embeds" in batch:
            return shard(batch["embeds"].to(ly.PDTYPE), "batch", "seq",
                         "embed")
        batch = batch["tokens"]
    return ly.embed_tokens(params["embed"], batch)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch`` ({"tokens" or "embeds",
    "labels"}) plus the summed aux loss (the moe family's router
    load-balance loss; 0 for the others): the reference's ``loss_fn``."""
    y, aux = _train_forward(params, embed_inputs(params, batch), cfg)
    return ly.cross_entropy(params, y, batch["labels"], cfg) + aux


def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                index: torch.Tensor, cfg: ModelConfig,
                tables: Optional[torch.Tensor] = None,
                kernels: Optional[bool] = None,
                sketch: Optional[dict] = None, rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, dict]:
    """tokens: (B, 1) int; index: (B,) int32 positions; tables: (B, nb)
    int32 (attention families; None for the recurrent ones, whose slot
    cache is ``init_cache``'s); ``sketch``: optional two-span state,
    ``rows`` the padded row count (see forward).  Returns (logits (B, Vp)
    f32, cache updated in place)."""
    if cfg.family in RECURRENT_FAMILIES:
        y, cache = forward(params, embed_inputs(params, tokens), cfg,
                           mode="decode", cache=cache, index=index)
        return ly.logits_fn(params, y, cfg)[:, 0], cache
    logits, cache = verify_step(params, cache, tokens, index, cfg, tables,
                                kernels=kernels, sketch=sketch, rows=rows)
    return logits[:, 0], cache


def verify_step(params: Params, cache: dict, tokens: torch.Tensor,
                index: torch.Tensor, cfg: ModelConfig,
                tables: torch.Tensor, kernels: Optional[bool] = None,
                sketch: Optional[dict] = None, rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, dict]:
    """Speculative verification (the reference's ``verify_step``): score
    C tokens per slot in one multi-query decode against the paged pool.

    tokens: (B, C) int — each slot's last committed token followed by its
    C - 1 draft proposals; index: (B,) int32, the slot's decode position.
    Rows for positions index[b] .. index[b] + C - 1 scatter through the
    slot's block table as C successive decode steps would (rows past the
    table land in the write sink), and the logits (B, C, Vp) f32 at
    position index[b] + i are what a decode step would give after
    committing tokens[:, :i + 1]: bitwise, when both run their rows in
    slabs of one ``rows`` count (models/layers.py, row padding; the
    library GEMMs and row reductions pick their order by shape) and since
    the paged kernel's KV splits ignore C (kernels/paged_attention.py:
    plan).  Past ``rows`` the B*C rows run as several slabs of it.
    Rejected rows above the accepted prefix are rewritten by the next
    round before any query can attend them."""
    B, C = tokens.shape
    x = embed_inputs(params, tokens)
    y = _paged_forward(params, x, cfg, cache, index.to(torch.int32),
                       tables, kernels, sketch, rows)
    logits = ly.logits_fn(params, y, cfg, rows=B * C, slab=rows)
    return logits.view(B, C, -1), cache


def prefill_chunk(params: Params, cache: dict, tokens: torch.Tensor,
                  table: torch.Tensor, start, cfg: ModelConfig,
                  kernels: Optional[bool] = None,
                  sketch: Optional[dict] = None) -> dict:
    """Chunked prefill step: write KV rows for absolute positions
    [start, start + C) into the pool through the slot's
    (blocks_per_slot,) block-table row, attending the chunk against
    everything the table already references below it.  tokens: (1, C);
    start: int or (1,) int32; ``sketch``: optional two-span state of
    this one slot (its (1,) fold_base and (2, L, 1, ...) tail view; see
    forward).  No logits: decode resumes at the last prompt position and
    recomputes that row."""
    dev = tokens.device
    # a fill, not a host-to-device copy: no wait on the stream
    st = (start.to(device=dev, dtype=torch.int32).reshape(1)
          if torch.is_tensor(start)
          else torch.full((1,), start, dtype=torch.int32, device=dev))
    tbl = table.to(device=dev, dtype=torch.int32).reshape(1, -1)
    _paged_forward(params, embed_inputs(params, tokens), cfg, cache, st,
                   tbl, kernels, sketch)
    return cache
