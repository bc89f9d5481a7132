"""Config system of the PyTorch port: a copy of the JAX package's
``configs/base.py`` (plain frozen dataclasses, no framework imports), so
the port reads the same model and serve geometry without importing the
reference package.

Every ported architecture gets one module in this package exporting
``CONFIG: ModelConfig``; ``repro_torch.configs.registry`` maps ``--arch``
ids to them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sketch (paper technique) configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Fast-Count-Sketch settings for framework integration points.

    ``head_mode_hash_len``: per-mode hash length J_n used when sketching the
    LM head weight (treated as an order-2 tensor (d_model, vocab)).  The
    sketched dim is J~ = sum(J_n) - N + 1.
    ``grad_hash_ratio``: target compression ratio for FCS gradient
    compression on the pod axis (sketch length ~= numel / ratio).
    ``num_sketches``: D independent sketches (median combine).
    ``opt_state_ratio``: > 0 moves AdamW (m, v) moments for large leaves
    into count-sketch tables of ~numel/ratio entries per moment
    (sketch/optimizer.py, through the sketch_update kernel on the card);
    0 keeps the dense optimizer (default).
    ``opt_state_rows``: sketch rows per table (median/min combine width).
    ``opt_state_min_elems``: leaves smaller than this stay dense.
    """

    sketched_head: bool = False
    head_hash_len: int = 4096
    grad_compression: bool = False
    grad_hash_ratio: int = 16
    num_sketches: int = 1
    opt_state_ratio: int = 0
    opt_state_rows: int = 3
    opt_state_min_elems: int = 1 << 16
    seed: int = 1234


# ---------------------------------------------------------------------------
# Serving configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching engine knobs (repro_torch.serve.scheduler).

    ``max_batch``/``max_seq``: the fixed slot-state geometry — every
    device tensor of the slot state keeps one shape for the engine's
    lifetime.  Sampling params (temperature / top-k / seed) are
    per-request, carried as per-slot engine state.
    ``decode_chunk``: decode steps per scheduler intervention (the length
    of the device-side step loop); admission/retirement happens between
    chunks.
    ``prefill_bucket``: the chunked-prefill chunk size for attention
    families — prompts (and cached-prefix suffixes of any length) are fed
    through chunks of this many tokens at absolute bucket offsets, so
    every prefill call has one shape.  The tail chunk is
    zero-padded; pad rows are causally dead, but for the moe family they
    still compete in expert-capacity dispatch — set 1 for exact-length
    chunks.  Recurrent families ignore it (exact-length prefill: trailing
    pad tokens would corrupt a recurrence).
    ``kv_block_size``: paged-KV page size in tokens.  Attention families
    store KV in a (L, num_kv_blocks, kv_block_size, K, hd) block pool;
    each slot holds a block table of physical block ids, so a request
    reserves ceil((S + max_new) / kv_block_size) blocks instead of
    max_seq rows.  Must divide ``prefix_block`` so cached prefixes share
    whole pool blocks by reference.
    ``num_kv_blocks``: pool size in blocks; 0 (default) auto-sizes to the
    dense equivalent, max_batch * ceil(max_seq / kv_block_size) — set it
    lower to cap pool memory (admission then waits for free blocks and
    evicts idle prefix-cache entries under pressure).
    ``admit_threshold``: a prompt prefix's KV block is admitted to the
    bounded prefix cache only once its count-min estimated frequency
    reaches this value (TinyLFU-style sketch-gated admission; count-min's
    one-sided overestimate can only admit early, never starve).
    ``prefix_block``: prefix granularity in tokens — block-multiple
    prefixes are counted/cached.
    ``prefix_cache_bytes``: hard byte budget for prefix-cache-held pool
    blocks (LRU eviction keeps the total at or under this; an entry's
    blocks only return to the free list when no live slot references
    them).
    ``cm_cols``/``cm_rows``: count-min table geometry (O(table) state
    regardless of unique-prompt cardinality).
    ``cm_decay_every``/``cm_decay``: every N observed prompts the counts
    are aged by the decay factor so stale prefixes lose admission priority.
    ``spec_k``: speculative decoding (attention families): a cheap draft
    model proposes up to ``spec_k`` tokens per slot per round and the
    served model verifies all of them in ONE multi-query decode step
    (``transformer.verify_step``); greedy speculative output is
    token-for-token identical to plain greedy decode.  0 (default)
    disables speculation and keeps the classic one-token decode chunk.
    Per-request ``Request.spec_k`` overrides, clamped to this engine max.
    ``draft_depth``: layers of the served stack kept in the derived draft
    proposer (``models/draft.py:make_draft`` — a truncated prefix of the
    block stack sharing embed/norm/head).
    ``draft_sketch_ratio``: > 0 additionally count-sketch-compresses the
    draft's block weights along their contraction dim at this ratio and
    swaps the draft's LM head for the FCS-sketched head (paper Section
    4.2 machinery) at the same ratio — the paper's compressed-forward
    recipe applied to drafting.  0 keeps the truncated weights dense.
    ``kv_sketch_window``: > 0 turns on the sketched long-context KV
    subsystem (attention families, ``serve/kv_sketch.py``): each slot
    keeps this many recent tokens of EXACT paged KV; when a whole block
    ages past the window it is folded into a per-slot, per-layer
    count-sketch tail table (keys and values sketched along the sequence
    axis with ``sketch/hashing.py`` rows) and freed back to the pool, so
    a slot's pool reservation is bounded by the window, not the context.
    Decode attention becomes two-span: exact over the window plus an
    approximate tail contribution merged with online-softmax statistics.
    Must be a multiple of ``kv_block_size``.  0 (default) disables the
    subsystem entirely — the engine builds the classic exact graph.
    Per-request ``Request.kv_sketch=False`` opts a request out (it then
    reserves its full context exactly, as without the subsystem).
    ``kv_sketch_ratio``: sequence-axis compression ratio of the tail
    tables — each table row has ~max_seq/ratio columns (lane-aligned), so
    tail bytes are ~2 * rows/ratio of the folded KV bytes.
    ``kv_sketch_rows``: independent hash rows per tail table (median
    combine width; the FCS D parameter applied to KV).
    ``queue_depth``: backpressure bound for the async front-end
    (``serve/frontend.py``): at most this many submitted-but-unadmitted
    requests may wait in the scheduler queue; an ``AsyncServeEngine.
    submit`` beyond it awaits (never raises) until admissions/retirements
    drain the queue.  The synchronous ``SlotScheduler.submit`` path is
    not bounded — batch callers hand the whole request list over at once.
    ``default_deadline_s``: seconds-from-submission deadline applied to
    requests that don't carry their own; a request past its deadline is
    expired — dropped from the queue, or retired mid-flight with the
    tokens it produced so far (``Completion.status == "expired"``).
    0 (default) means no deadline.
    ``preemption``: allow the admission path to preempt a strictly
    lower-priority running slot when a higher-priority request cannot be
    admitted (no free slot, or the block pool can't serve it).  The
    victim retires through the normal slot-retire + block-free path and
    is requeued as a continuation request (prompt + tokens so far), so
    its final output is unchanged — preemption trades its latency for
    the high-priority request's.  True by default; deadline expiry works
    regardless.
    ``paged_kernels``: attention implementation for the paged serve path
    (decode / chunked prefill).  None (default) picks by the tensors'
    device: the hand-written CUDA kernel
    (``kernels/csrc/paged_attention.cu`` — one pass over each slot's block
    table, no dense gathered KV copy) for CUDA tensors, the plain PyTorch
    version (``kernels/ref.py``) for CPU tensors.  True demands the kernel
    and raises on the CPU (a CUDA kernel has no interpret mode).  False is
    an explicit request for the plain version on either device.
    """

    max_batch: int = 8
    max_seq: int = 512
    decode_chunk: int = 8
    prefill_bucket: int = 32
    kv_block_size: int = 16
    num_kv_blocks: int = 0
    admit_threshold: int = 2
    prefix_block: int = 16
    prefix_cache_bytes: int = 1 << 24
    cm_cols: int = 1024
    cm_rows: int = 4
    cm_decay_every: int = 1024
    cm_decay: float = 0.5
    seed: int = 0
    spec_k: int = 0
    draft_depth: int = 1
    draft_sketch_ratio: int = 0
    kv_sketch_window: int = 0
    kv_sketch_ratio: int = 8
    kv_sketch_rows: int = 3
    queue_depth: int = 64
    default_deadline_s: float = 0.0
    preemption: bool = True
    paged_kernels: Optional[bool] = None


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    expert_d_ff: int = 0
    group_size: int = 128          # GShard dispatch group (tokens)
    capacity_factor: float = 1.5
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    # xLSTM[m:s] block pattern: each group = `m_per_group` mLSTM blocks
    # followed by `s_per_group` sLSTM blocks.
    m_per_group: int = 7
    s_per_group: int = 1
    proj_factor_m: float = 2.0
    proj_factor_s: float = 4.0 / 3.0


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    # Zamba2-style: `mamba_per_group` Mamba2 layers then one application of a
    # shared transformer block; `num_shared_blocks` distinct shared blocks
    # used round-robin.
    mamba_per_group: int = 6
    num_shared_blocks: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    act: str = "silu"                # silu | gelu
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # sub-config blocks (None for families that don't use them)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    sketch: SketchConfig = SketchConfig()
    serve: ServeConfig = ServeConfig()
    # frontend stub for [audio]/[vlm]: train/prefill consume precomputed
    # frame/patch embeddings instead of token ids.
    frontend: str = "none"           # none | audio_stub | vision_stub
    # True when decode with a 500k context is architecturally sane
    # (sub-quadratic / constant-state sequence mixing).
    supports_long_context: bool = False
    # source citation for the config
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-style) so the head is
        evenly shardable over a 16-way model axis with 128-lane alignment."""
        return int(math.ceil(self.vocab_size / 256) * 256)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count of the model as implemented (total)."""
        d, v = self.d_model, self.padded_vocab
        n = 0
        n += v * d                                # embedding
        if not self.tie_embeddings:
            n += v * d                            # head
        n += d                                    # final norm
        per_layer = self._block_param_count()
        n += per_layer
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed-in experts)."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        # subtract inactive routed experts
        expert_params = 3 * d * m.expert_d_ff
        inactive = (m.num_experts - m.top_k) * expert_params * self.num_layers
        return total - inactive

    def _block_param_count(self) -> int:
        d = self.d_model
        hd = self.resolved_head_dim
        H, K = self.num_heads, self.num_kv_heads
        attn = d * H * hd + 2 * d * K * hd + H * hd * d
        if self.qkv_bias:
            attn += (H + 2 * K) * hd
        ffn_glu = 3 * d * self.d_ff
        norms = 2 * d
        L = self.num_layers
        if self.family in ("dense", "audio", "vlm"):
            return L * (attn + ffn_glu + norms)
        if self.family == "moe":
            m = self.moe
            router = d * m.num_experts
            experts = m.num_experts * 3 * d * m.expert_d_ff
            shared = m.num_shared_experts * 3 * d * m.expert_d_ff
            return L * (attn + router + experts + shared + norms)
        if self.family == "ssm":
            x = self.xlstm
            gm = x.m_per_group + x.s_per_group
            n_groups = L // gm
            dm = int(d * x.proj_factor_m)
            # mLSTM block: up-proj (2x for gate), qkv projections on inner dim,
            # i/f/o gate projections, down-proj, norms
            mlstm = (2 * d * dm) + 3 * dm * (dm // self.num_heads) * self.num_heads \
                + 3 * dm * self.num_heads + dm * d + 2 * d + 2 * dm
            ds = int(d * x.proj_factor_s)
            # sLSTM: 4 gates x (input proj + recurrent per-head proj) + FFN-ish up/down
            slstm = 4 * (d * d + self.num_heads * (d // self.num_heads) ** 2) \
                + 2 * d * ds + ds * d + 2 * d
            return n_groups * (x.m_per_group * mlstm + x.s_per_group * slstm)
        if self.family == "hybrid":
            hb = self.hybrid
            s = self.ssm
            di = s.expand * d
            nheads = di // s.head_dim
            # mamba2 block params
            mamba = d * (2 * di + 2 * s.d_state + nheads) + s.conv_width * (di + 2 * s.d_state) \
                + nheads + nheads + di * d + d + di
            shared_blk = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                          + self.num_heads * hd * d + 3 * d * self.d_ff + 2 * d)
            return L * mamba + hb.num_shared_blocks * shared_blk
        raise ValueError(self.family)

    def flops_per_token(self, seq_len: int, training: bool) -> float:
        """Model FLOPs per token: 6*N_active (train) or 2*N_active (fwd),
        plus attention score FLOPs where applicable."""
        n = self.active_param_count()
        base = (6.0 if training else 2.0) * n
        # causal attention term: 2 * 2 * hd * H * S/2 per token per layer
        hd = self.resolved_head_dim
        if self.family in ("dense", "audio", "vlm", "moe"):
            attn_layers = self.num_layers
        elif self.family == "hybrid":
            attn_layers = self.num_layers // self.hybrid.mamba_per_group
        else:
            attn_layers = 0
        attn = attn_layers * 2 * 2 * self.num_heads * hd * (seq_len / 2)
        if training:
            attn *= 3
        return base + attn


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for LM-family transformers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k only runs for sub-quadratic sequence mixers (SSM/hybrid)."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
