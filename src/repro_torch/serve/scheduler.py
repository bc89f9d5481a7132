"""Continuous-batching slot scheduler over a paged KV pool, or over the
recurrent families' slot state (port of ``repro/serve/scheduler.py``).

The engine owns ``max_batch`` slots.  KV lives in one shared
(L, num_kv_blocks + 1, kv_block_size, K, hd) block pool on the device
(the last block of each layer is a write sink, see models/layers.py) and
every slot holds a (blocks_per_slot,) int32 block table; a request
reserves ceil((S + max_new) / kv_block_size) blocks from the host-side
``BlockAllocator`` instead of max_seq rows.  Every device tensor of the
slot state keeps its shape for the engine's lifetime.

Prefill is chunked: the prompt is fed through ``prefill_chunk`` in
``prefill_bucket``-sized chunks at absolute bucket offsets, scattered
through the slot's table.  A freshly admitted request resumes decode at
``pos = S - 1`` by re-feeding its last prompt token, so the first output
token is sampled by the decode chunk and prefill produces no logits.  The
host plans the chunks (boundaries, lazy block allocation, the
fold-through between chunks) and writes each chunk's tokens, table row,
offset, fold base and slot into one static buffer with one copy; on the
card the chunk's captured graph replays on it, and without graphs the
same chunk runs eagerly (``_prefill_one``).

Decode runs ``decode_chunk`` steps per scheduler round as device work
that never waits on the host: per-slot position, remaining budget,
temperature and top-k are device tensors, finished and idle slots keep
running masked (an idle slot's table row is all sentinels, so its KV
write lands in the sink), and the chunk's tokens and emit masks are
stacked on the device and copied to the host once, at ``collect``.
Whether a chunk samples at all is decided on the host from its mirror of
the slots' temperatures, so a greedy-only chunk pays only an argmax; a
sampling chunk draws for every slot from that slot's generator (one per
slot, owned by the engine) and keeps the draw where the slot's
temperature is positive, so greedy slots stay independent of their
neighbours.  A slot's generator takes its request's state at admission
(``Request.generator``'s, or a seed's) and gives it back to
``Request.generator`` when the slot is released.

On the card the decode chunk and the prefill chunk are each captured
once per variant as CUDA graphs and replayed (serve/graphs.py; the
prefill graphs in a memory pool of their own); ``decode_compilations``
and ``prefill_compilations`` count the captures.  ``graphs=False`` keeps
both chunks eager, the CPU's path, as the card's twin.

Prefix reuse is gated by the count-min admission filter in
serve/prefix_cache.py and is zero-copy: a hit writes the cached entry's
physical block ids into the new slot's table and bumps their refcounts.

The host loop is split into pump phases — ``admit_pending`` /
``dispatch`` / ``collect``, plus ``cancel`` / ``preempt`` /
``expire_deadlines`` at pump boundaries — that ``step()`` composes
synchronously and serve/frontend.py drives as an async pump.  On the card
``dispatch`` only enqueues work, so admission and prefill for the next
round overlap the chunk in flight; both run on one stream, so the chunk
never sees the later admission's writes.

Sketched long-context KV (``kv_sketch_window > 0``, serve/kv_sketch.py):
a sketched slot holds only its recent window of exact blocks.  Prefill
allocates blocks lazily ahead of the write frontier and folds blocks that
aged past the window into the slot's FCS tail tables
(``_sketch_prefill_admit``); at each decode dispatch ``_plan_folds``
extends the slot's blocks for the coming chunk and decides how many aged
rows fold at the chunk's head, and ``_finish_folds`` frees the folded
blocks after the chunk is enqueued.  The integer bookkeeping is the
reference's.  A chunk or prefill in which no slot has folded anything
runs the sketch-free attention, which is what the sketched attention
selects for such slots anyway (the ``fold_base == 0`` anchor); host
mirrors tell which.

Speculative decoding (``serve.spec_k > 0`` / per-request
``Request.spec_k``, serve/speculative.py): a draft (``models/draft.py``,
truncated and/or count-sketch-compressed, or given as ``draft=``) keeps
its own shallow paged pool in ``cache["draft"]`` (and its own tail when
sketched), on the target's block ids, tables and refcounts; it prefills
in lockstep with the target, proposes K tokens a round, and the target
verifies them in one multi-query step.  Greedy speculative output is
token for token plain greedy output: a decode step pads its rows to
``step_rows`` (models/layers.py, row padding), and a verify step's
max_batch * (spec_k + 1) rows (and a sketched engine's tail-span rows)
run in slabs of the decode step's shape, at any spec_k.  For the moe
family this holds while no choice is dropped: a verify step routes
B * (spec_k + 1) rows where decode routes B, so where an expert's
capacity can fill, a verify row may drop a choice that its decode step
would keep (or the reverse), as in the reference.  Every slot of a spec engine
reserves ``spec_overhang`` = spec_k rows past its demand, as the
reference's books do; verify and draft writes above the committed
position stay in its own blocks below max_seq and land in the write sink
past it (the model sees the first ``attn_blocks`` table entries, the
plain engine's table width).  A slot never writes a block that another
holder shares: after admission ``_ensure_exclusive`` forks (copy-on-write,
both pools) every shared block its decode region reaches, because a
verify step writes proposals that may be rejected.

Observability (``obs=`` / ``set_observer``, a ``repro_torch.obs.
ServeObserver`` or None): the scheduler and its prefix cache report the
reference's events at the reference's places — submission, admission and
deferral, each prefill chunk's host launch time, folds, speculative
rounds, each collected round, retirement, cancellation and preemption.
Every hook runs on the host around the launches, outside the captured
chunks (a hook inside a captured body would run once, at capture), and
takes host values only; the one device read is the opt-in fidelity probe
at ``collect()`` (``_probe_fidelity``).

Families: dense, moe (models/moe.py), audio and vlm (dense stacks that
serve token ids).  The chunk prefill's tail is padded with token 0, and
for the moe family those pad rows route and take expert capacity, as in
the reference; ``prefill_bucket=1`` gives exact-length chunks.  Decode
and verify route only their B*S live rows (models/transformer.py).

The recurrent families (ssm: xlstm-1.3b; hybrid: zamba2-2.7b) keep no
pool: the slot state is ``transformer.init_cache(cfg, max_batch,
max_seq)``, every leaf (n, max_batch, ...) with no row padding (it needs
none: these engines do not speculate), and there is no allocator,
prefix cache or sketch (``alloc`` and ``prefix_cache`` are None, the
block geometry 0).  Admission prefills the first S - 1 prompt tokens at
their exact length (a pad token would enter the recurrence) and copies
the resulting state into the slot in place, or zeroes the slot for a
1-token prompt: either way every leaf of the slot is rewritten (the
hybrid family's KV rows from S - 1 up stay masked until decode writes
them), so an earlier occupant's state is never observed.  Decode resumes
at ``pos = S - 1`` with the last prompt token, which the first decode
step consumes exactly once.  The decode chunk is the same chunk without
tables, captured once per variant like the attention families'.  The
prefill runs eagerly: the reference compiles it once per distinct prompt
length, and a graph per length would keep a private pool per length
without bound, so ``prefill_compilations`` is 0 here.  The observer sees
the same events as the reference's, which emits no prefill, prefix or
fold event for these families.

Speculation runs on every attention family (dense, moe, audio, vlm) and
config, attention biases included, at any spec_k.  It needs a kv-cache
family: a recurrent one raises ``ValueError``, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models import layers as ly
from repro_torch.models.draft import Draft, make_draft
from repro_torch.serve import kv_sketch as kvs
from repro_torch.serve import speculative as spec
from repro_torch.serve.graphs import ChunkGraphs, PrefillVariant, Variant
from repro_torch.serve.prefix_cache import SketchPrefixCache


@dataclass
class Request:
    rid: int
    tokens: np.ndarray           # (S,) int32 prompt
    max_new: int
    # per-request sampling: None temperature falls back to the scheduler
    # default; top_k == 0 disables top-k filtering.  A sampled request's
    # slot generator starts from ``generator``'s state when given (and
    # gives the advanced state back to it when the slot is released),
    # else from ``seed``, else from the scheduler's base seed plus the
    # rid.  A generator serves one request in flight at a time.
    temperature: Optional[float] = None
    top_k: int = 0
    seed: Optional[int] = None
    generator: Optional[torch.Generator] = None
    # sketched long-context KV: None follows the engine (on when
    # kv_sketch_window > 0); False opts this request out — it reserves
    # full exact coverage and never folds
    kv_sketch: Optional[bool] = None
    # SLO scheduling: higher priority admits first and may preempt
    # strictly lower-priority running slots; ``deadline`` is an absolute
    # time.monotonic() past which the request expires
    priority: int = 0
    deadline: Optional[float] = None
    # speculative tokens per round: None -> the engine default
    # (serve.spec_k), clamped to the engine max; 0 decodes this request
    # plainly inside a speculative engine
    spec_k: Optional[int] = None


@dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: np.ndarray           # (<= max_new,) int32 generated
    prefix_hit: bool
    # "ok" | "cancelled" | "expired" (partial tokens in the last two)
    status: str = "ok"


def _stat(kind: str) -> Any:
    """An ``EngineStats`` field tagged with its merge kind: "counter"
    (sums), "gauge" (level over resources the scheduler owns; sums),
    "peak" (high-water mark; max) or "geometry" (constant; max)."""
    return dataclasses.field(default=0, metadata={"kind": kind})


@dataclass
class EngineStats:
    """One flat snapshot of a scheduler (or, merged, of an engine): queue
    pressure, slot occupancy, pool high-water marks and prefix-cache
    effectiveness.  Field names match the JAX package's ``EngineStats``.
    ``decode_compilations`` and ``prefill_compilations`` count the decode
    and prefill chunks' CUDA graph captures (one per variant an engine
    used; 0 on the CPU, which runs both chunks eagerly), where the
    reference counts XLA compilations.  A recurrent engine's prefill runs
    eagerly, so its ``prefill_compilations`` is 0 where the reference
    counts one compilation per distinct prompt length.  As in the
    reference, a recurrent engine's pool, KV byte and prefix fields stay
    0 (``SlotScheduler.kv_cache_bytes`` gives its state's bytes)."""
    queue_depth: int = _stat("gauge")
    active_slots: int = _stat("gauge")
    max_batch: int = _stat("gauge")
    completed: int = _stat("counter")
    cancelled: int = _stat("counter")
    expired: int = _stat("counter")
    preempted: int = _stat("counter")
    decode_steps: int = _stat("counter")
    decode_compilations: int = _stat("counter")
    prefill_compilations: int = _stat("counter")
    pool_blocks: int = _stat("gauge")
    block_size: int = _stat("geometry")
    blocks_reserved: int = _stat("gauge")
    blocks_free: int = _stat("gauge")
    blocks_peak: int = _stat("peak")
    kv_reserved_bytes: int = _stat("gauge")
    kv_peak_reserved_bytes: int = _stat("peak")
    kv_peak_used_bytes: int = _stat("peak")
    kv_dense_equiv_bytes: int = _stat("gauge")
    prefix_lookups: int = _stat("counter")
    prefix_hits: int = _stat("counter")
    prefix_admitted: int = _stat("counter")
    prefix_evicted: int = _stat("counter")
    prefix_cached_bytes: int = _stat("gauge")
    fold_rows: int = _stat("counter")   # exact rows folded into tails
    kv_sketch_tail_bytes: int = _stat("gauge")
    spec_rounds: int = _stat("counter")     # verify rounds of spec slots
    spec_proposed: int = _stat("counter")   # draft tokens proposed
    spec_accepted: int = _stat("counter")   # ... verified and emitted

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(self.prefix_lookups, 1)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of draft proposals that survived verification."""
        return self.spec_accepted / max(self.spec_proposed, 1)

    @property
    def mean_accepted_run(self) -> float:
        """Tokens emitted per verify round by speculating slots (accepted
        proposals plus the target's token): 1.0 means speculation never
        helps, spec_k + 1 is the ceiling."""
        return ((self.spec_accepted + self.spec_rounds)
                / max(self.spec_rounds, 1))

    @staticmethod
    def field_kinds() -> Dict[str, str]:
        """field name -> kind tag, the one record ``merge`` and
        ``repro_torch.obs.MetricsRegistry.update_from_stats`` share."""
        return {f.name: f.metadata.get("kind", "counter")
                for f in dataclasses.fields(EngineStats)}

    @staticmethod
    def merge(parts: Sequence["EngineStats"]) -> "EngineStats":
        """Counters and gauges sum; peaks and geometry take the max."""
        out = EngineStats()
        kinds = EngineStats.field_kinds()
        for p in parts:
            for name, kind in kinds.items():
                a, b = getattr(out, name), getattr(p, name)
                setattr(out, name, max(a, b) if kind in ("peak", "geometry")
                        else a + b)
        return out

    def format(self) -> str:
        """Human-readable multi-line report."""
        lines = [
            f"queue={self.queue_depth} active={self.active_slots}/"
            f"{self.max_batch} completed={self.completed} "
            f"(cancelled={self.cancelled} expired={self.expired} "
            f"preemptions={self.preempted})",
            f"decode: steps={self.decode_steps} "
            f"compilations={self.decode_compilations} "
            f"(prefill: {self.prefill_compilations})",
            f"paged KV: {self.pool_blocks} blocks x {self.block_size} "
            f"tokens, reserved={self.blocks_reserved} (peak "
            f"{self.blocks_peak}, free {self.blocks_free}) — "
            f"{self.kv_peak_reserved_bytes}B peak vs dense "
            f"{self.kv_dense_equiv_bytes}B",
            f"prefix cache: hit_rate={self.prefix_hit_rate:.2f} "
            f"({self.prefix_hits}/{self.prefix_lookups}), "
            f"admitted={self.prefix_admitted}, "
            f"evicted={self.prefix_evicted}, "
            f"cached_bytes={self.prefix_cached_bytes}",
        ]
        if self.fold_rows or self.kv_sketch_tail_bytes:
            lines.append(f"kv sketch: folded_rows={self.fold_rows}, "
                         f"tail_bytes={self.kv_sketch_tail_bytes}")
        if self.spec_rounds:
            lines.append(
                f"speculative: acceptance={self.acceptance_rate:.2f} "
                f"({self.spec_accepted}/{self.spec_proposed}), "
                f"mean_run={self.mean_accepted_run:.2f} over "
                f"{self.spec_rounds} rounds")
        return "\n".join(lines)


class BlockAllocator:
    """Host-side free-list allocator over the paged KV block pool.

    Every pool block has a refcount: 1 for the slot that allocated it,
    +1 per prefix-cache entry holding it, +1 per additional slot sharing
    it through a prefix hit.  A block returns to the free list exactly
    when its count reaches zero.  ``peak_reserved`` records the
    high-water mark of allocated blocks.
    """

    def __init__(self, num_blocks: int, block_bytes: int):
        self.num_blocks = num_blocks
        self.block_bytes = block_bytes
        self._free = list(range(num_blocks - 1, -1, -1))   # pop() -> 0,1,..
        self.rc = np.zeros((num_blocks,), np.int64)
        self.peak_reserved = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def reserved(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks (refcount 1 each); None if not enough free."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self.rc[ids] += 1
        self.peak_reserved = max(self.peak_reserved, self.reserved)
        return ids

    def ref(self, ids: Sequence[int]) -> None:
        for b in ids:
            self.rc[b] += 1

    def unref(self, ids: Sequence[int]) -> None:
        for b in ids:
            self.rc[b] -= 1
            assert self.rc[b] >= 0, f"block {b} over-unreffed"
            if self.rc[b] == 0:
                self._free.append(b)

    def fork(self, b: int) -> Optional[int]:
        """Copy-on-write preparation for one holder of block ``b``: the
        sole holder (refcount 1) keeps ``b``; otherwise a fresh block is
        taken (refcount 1), the caller's reference on ``b`` dropped and
        the new id returned, for the caller to copy the rows into and
        rebind.  None when no block is free (the caller defers)."""
        assert self.rc[b] >= 1, f"fork of unheld block {b}"
        if self.rc[b] == 1:
            return b
        ids = self.alloc(1)
        if ids is None:
            return None
        self.rc[b] -= 1          # rc > 1: never reaches the free list here
        return ids[0]

    def reserved_bytes(self) -> int:
        return self.reserved * self.block_bytes

    def peak_reserved_bytes(self) -> int:
        return self.peak_reserved * self.block_bytes


@dataclass
class DecodeState:
    """Device-resident slot state; every tensor keeps its shape for the
    engine's lifetime and is updated in place."""
    cache: Dict[str, Any]        # {"kv": {"k", "v"}} block pool (+ sink),
                                 # "tail", and a spec engine's "draft"; a
                                 # recurrent family's stacked slot state
    tables: torch.Tensor         # (B, blocks_per_slot) int32 block tables
                                 # ((B, 0) for a recurrent family)
    cur: torch.Tensor            # (B, 1) int64 next token to feed
    pos: torch.Tensor            # (B,) int32 write/attend position
    remaining: torch.Tensor      # (B,) int32 output tokens still owed
    temp: torch.Tensor           # (B,) f32 sampling temperature
    top_k: torch.Tensor          # (B,) int32 top-k cutoff (0 = off)
    fold_base: torch.Tensor      # (B,) int32 first exact (unfolded) row
    spec_k: torch.Tensor         # (B,) int32 proposals per round


@dataclass
class PrefillInputs:
    """The prefill chunk's static inputs: one chunk of one slot, views of
    one int64 buffer at an address fixed for the engine's life, which the
    host writes with one copy before each chunk."""
    buf: torch.Tensor            # (bucket + blocks_per_slot + 3,) int64
    tokens: torch.Tensor         # (1, prefill_bucket) chunk tokens
    table: torch.Tensor          # (1, blocks_per_slot) table row
    offset: torch.Tensor         # (1,) absolute row of token 0
    fold_base: torch.Tensor      # (1,) the slot's first exact row
    slot: torch.Tensor           # (1,) slot whose tails it attends

    @classmethod
    def make(cls, bucket: int, width: int, sentinel: int,
             device: torch.device) -> "PrefillInputs":
        buf = torch.zeros((bucket + width + 3,), dtype=torch.int64,
                          device=device)
        tokens, table, offset, fold_base, slot = buf.split(
            [bucket, width, 1, 1, 1])
        table.fill_(sentinel)
        return cls(buf, tokens.view(1, bucket), table.view(1, width),
                   offset, fold_base, slot)


# device times kept per kind of chunk (``chunk_ms``, ``prefill_ms``): the
# newest, so a long-lived engine's record stays bounded
TIMINGS_KEPT = 10_000


class SlotScheduler:
    def __init__(self, cfg: ModelConfig, params: Any,
                 serve: Optional[ServeConfig] = None,
                 temperature: float = 0.0, device: DeviceLike = None,
                 draft: Optional[Draft] = None,
                 graphs: Optional[bool] = None, obs: Any = None):
        """``graphs``: the decode and prefill chunks as captured CUDA
        graphs (serve/graphs.py).  None captures on the card and runs
        eagerly on the CPU; True demands graphs and raises on the CPU;
        False runs the eager chunks on either (the card's twin).
        ``obs``: a ``repro_torch.obs.ServeObserver`` to report into (see
        ``set_observer``)."""
        sv = serve if serve is not None else cfg.serve
        if sv.spec_k > 0 and cfg.family not in tf.ATTN_FAMILIES:
            raise ValueError(f"speculative decode needs a kv-cache family "
                             f"{tf.ATTN_FAMILIES}, got {cfg.family!r}")
        if cfg.family not in tf.ATTN_FAMILIES + tf.RECURRENT_FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {self.device}")
        if sv.paged_kernels and self.device.type != "cuda":
            raise ValueError("paged_kernels=True needs a CUDA device: the "
                             "CUDA kernel has no CPU or interpret mode")
        if graphs and self.device.type != "cuda":
            raise ValueError("graphs=True needs a CUDA device: CUDA graphs "
                             "have no CPU mode")
        self.cfg = cfg
        self.params = params
        self.serve = sv
        self.temperature = float(temperature)   # default for requests
        # paged attention implementation: None picks by device
        self.use_kernels = sv.paged_kernels
        self.is_kv = cfg.family in tf.ATTN_FAMILIES
        B = sv.max_batch
        # speculative decode: an explicit draft wins; else one derived from
        # the serve knobs (None when spec_k == 0)
        self.draft = draft if draft is not None else make_draft(params, cfg,
                                                                 sv)
        if self.draft is not None and not self.is_kv:
            raise ValueError("speculative decode needs a kv-cache family")
        self.spec_max = int(sv.spec_k) if self.draft is not None else 0
        # decode steps pad their rows to the plain engine's count of this
        # max_batch, and verify steps run theirs in slabs of it, so a
        # verify row is bitwise that engine's decode row at any spec_k
        # (models/layers.py, row padding)
        self.step_rows = ly.padded_rows(B)
        self.spec_rounds = 0       # verify rounds run by speculating slots
        self.spec_proposed = 0     # draft tokens proposed in those rounds
        self.spec_accepted = 0     # draft tokens verified and emitted
        # host mirror of each slot's proposals per round (0 for sampled
        # slots, which never accept proposals)
        self._slot_spec: List[int] = [0] * B
        self.forks = 0             # copy-on-write block forks made
        self._queue: List[Request] = []
        self._slot_req: List[Optional[Request]] = [None] * B
        self._slot_out: List[List[int]] = [[] for _ in range(B)]
        self._slot_hit: List[bool] = [False] * B
        self._slot_blocks: List[List[int]] = [[] for _ in range(B)]
        self._slot_rows: List[int] = [0] * B
        # host mirrors of per-slot device state: the pump phases never
        # read device tensors, so the next round's host work overlaps the
        # chunk in flight
        self._slot_temp: List[float] = [0.0] * B
        # one generator per slot, owned by the engine (a CUDA graph draws
        # only from generators registered at its capture)
        self._slot_gen = [torch.Generator(device=self.device)
                          for _ in range(B)]
        self._slot_admit_seq: List[int] = [0] * B
        # decode resumes at S - 1 and collect() advances the mirror by the
        # tokens emitted, so fold planning never reads device positions
        self._slot_pos: List[int] = [0] * B
        # sketched KV: first live logical block per slot (host mirror of
        # fold_base / block_size) and whether the slot folds at all
        self._slot_first_lblk: List[int] = [0] * B
        self._slot_use_sketch: List[bool] = [False] * B
        self.fold_rows_total = 0
        self._admit_seq = 0
        # rid -> pending admit_plen, set on a request's FIRST admission
        # attempt so pool-pressure retries don't re-feed the count-min
        self._admit_memo: Dict[int, Optional[int]] = {}
        # rid -> (original prompt_len, tokens emitted before preemption,
        # prefix_hit so far)
        self._preempted: Dict[int, Tuple[int, List[int], bool]] = {}
        # the chunk in flight between dispatch() and collect(): stacked
        # (2, chunk, B) tokens/emits plus its timing events on the card
        self._inflight: Optional[Tuple[torch.Tensor, Any]] = None
        # device time per decode chunk, and per prefill chunk (newest
        # TIMINGS_KEPT of each)
        self.chunk_ms: deque = deque(maxlen=TIMINGS_KEPT)
        self.prefill_ms: deque = deque(maxlen=TIMINGS_KEPT)
        # prefill chunks' timing events not yet read (the last may still
        # be queued behind a decode chunk)
        self._prefill_events: deque = deque()
        self.cancellations = 0
        self.expirations = 0
        self.preemptions = 0
        self._used_rows = 0
        self.peak_used_rows = 0
        self.decode_steps = 0
        self.completed: List[Completion] = []
        self._base_seed = int(sv.seed)
        # observability (repro_torch.obs.ServeObserver or None): every
        # hook site guards with ``if self.obs is not None`` and passes
        # host values only; ``_round_idx`` paces the opt-in fidelity probe
        self.obs: Any = None
        self._round_idx = 0

        if self.is_kv:
            cache, tables = self._init_pool(cfg, sv, B)
        else:
            cache, tables = self._init_recurrent(cfg, sv, B)
        dev = self.device
        self._state = DecodeState(
            cache=cache,
            tables=tables,
            cur=torch.zeros((B, 1), dtype=torch.int64, device=dev),
            pos=torch.zeros((B,), dtype=torch.int32, device=dev),
            remaining=torch.zeros((B,), dtype=torch.int32, device=dev),
            temp=torch.zeros((B,), dtype=torch.float32, device=dev),
            top_k=torch.zeros((B,), dtype=torch.int32, device=dev),
            fold_base=torch.zeros((B,), dtype=torch.int32, device=dev),
            spec_k=torch.zeros((B,), dtype=torch.int32, device=dev),
        )
        # the prefill chunk's inputs, at addresses fixed for the engine's
        # life: the prefill chunk reads only these, and the host writes
        # them before each chunk (``_stage_prefill``)
        self._pf = (PrefillInputs.make(self.prefill_bucket,
                                       self.blocks_per_slot, self.num_blocks,
                                       dev) if self.is_kv else None)
        self._graphs: Optional[ChunkGraphs] = None
        self._prefill_graphs: Optional[ChunkGraphs] = None
        if graphs is None:
            graphs = self.device.type == "cuda"
        if graphs:
            self._graphs = ChunkGraphs(self._slot_gen)
            if self.is_kv:
                self._prefill_graphs = ChunkGraphs(())
            # every lazy first call of every variant before any capture,
            # while every slot is idle: sentinel tables (the prefill's
            # static row too) send each KV write to the sink, remaining ==
            # 0 keeps every position, admission resets ``cur`` and reseeds
            # the slot's generator, and the sketched prefill only reads
            # slot 0's tails, zeros until its first admission (a recurrent
            # engine's idle slots decode junk state, which the next
            # admission rewrites whole)
            for v in self._usable_variants():
                self._chunk(v)
            for pv in self._prefill_variants():
                self._prefill_static(pv)
        if obs is not None:
            self.set_observer(obs)

    def _init_pool(self, cfg: ModelConfig, sv: ServeConfig, B: int
                   ) -> Tuple[dict, torch.Tensor]:
        """The attention families' paged pool (and tails, and a spec
        engine's draft pool), its allocator and prefix cache, and the
        sentinel block tables."""
        self.block_size = max(1, sv.kv_block_size)
        if sv.prefix_block % self.block_size:
            raise ValueError(f"kv_block_size {self.block_size} must divide "
                             f"prefix_block {sv.prefix_block} so cached "
                             f"prefixes share whole blocks")
        # verify and draft writes overhang the committed sequence by up to
        # spec_max rows; every slot of a spec engine (the verify step is
        # batch-wide) reserves them, so they land in its own blocks
        self.spec_overhang = self.spec_max
        self.blocks_per_slot = -(-(sv.max_seq + self.spec_overhang)
                                 // self.block_size)
        # the model reads and writes through the first attn_blocks entries
        # of each table: positions past max_seq (a verify step's rejected
        # overhang at the end of a long request) land in the write sink,
        # and the paged kernel's split plan, which reads the table width,
        # is the plain engine's, so verify rows are its decode rows
        self.attn_blocks = -(-sv.max_seq // self.block_size)
        self.prefill_bucket = max(1, min(sv.prefill_bucket, sv.max_seq))
        nb = sv.num_kv_blocks or B * self.blocks_per_slot
        self.num_blocks = nb
        self.sketch_on = bool(sv.kv_sketch_window)
        tail = None
        if self.sketch_on:
            W, bs = int(sv.kv_sketch_window), self.block_size
            if W % bs or W < bs:
                raise ValueError(f"kv_sketch_window {W} must be a positive "
                                 f"multiple of kv_block_size {bs}")
            self.kv_window = W
            Z = max(1, int(sv.kv_sketch_rows))
            self.tail_rows = Z
            self.tail_cols = kvs.tail_cols(sv.max_seq,
                                           max(1, int(sv.kv_sketch_ratio)))
            self.tail_domain = kvs.pos_domain(sv.max_seq, bs)
            self.tail_coeffs = kvs.tail_coeffs(sv, device=self.device)
            self.tail_pos_hash = kvs.pos_buckets_signs(
                self.tail_coeffs, self.tail_domain, self.tail_cols)
            # max position advance per decode chunk; the in-chunk fold cap
            # keeps pace with it (+1 block so a lagging slot catches up)
            self.adv_max = sv.decode_chunk * (self.spec_max + 1)
            self.fold_cap = bs * (-(-self.adv_max // bs) + 1)
            self.prefill_fold_cap = bs * (self.prefill_bucket // bs + 1)
            tail = (B, Z, self.tail_cols)
        cache = tf.init_paged_cache(cfg, nb, self.block_size, self.device,
                                    tail=tail)
        layers = cfg.num_layers
        if self.draft is not None:
            # the draft's shallow pool mirrors the target's block for block
            # (same ids, tables and refcounts), so prefix sharing, forks
            # and frees cover both
            cache["draft"] = tf.init_paged_cache(
                self.draft.cfg, nb, self.block_size, self.device, tail=tail)
            layers += self.draft.cfg.num_layers
        # K and V, all layers of both pools, one block (the tail tables
        # are per-slot constant state, not paged)
        block_bytes = (2 * layers * self.block_size
                       * cfg.num_kv_heads * cfg.resolved_head_dim
                       * cache["kv"]["k"].element_size())
        self.alloc = BlockAllocator(nb, block_bytes)
        self.prefix_cache = SketchPrefixCache(
            sv, allocator=self.alloc, block_size=self.block_size)
        tables = torch.full((B, self.blocks_per_slot), nb, dtype=torch.int32,
                            device=self.device)
        return cache, tables

    def _init_recurrent(self, cfg: ModelConfig, sv: ServeConfig, B: int
                        ) -> Tuple[dict, torch.Tensor]:
        """A recurrent family's slot state, B rows: no pool, allocator,
        prefix cache or sketch; paging and prefix reuse are KV-cache
        concepts, and misuse fails on None.  Its bf16 leaves take the
        weights' dtype."""
        self.block_size = self.blocks_per_slot = self.num_blocks = 0
        self.spec_overhang = self.attn_blocks = 0
        self.alloc = None
        self.prefix_cache = None
        self.sketch_on = False
        # the state's bf16 leaves (conv buffers, the hybrid KV) take the
        # weights' dtype, so f32 weights serve wholly in f32
        cache = tf.init_cache(cfg, B, sv.max_seq, self.device,
                              self.params["embed"].dtype)
        return cache, torch.zeros((B, 0), dtype=torch.int32,
                                  device=self.device)

    def set_observer(self, obs: Any) -> None:
        """Attach (or detach, with None) a ``repro_torch.obs.
        ServeObserver``: the scheduler and its prefix cache report into it
        from every pump phase.  Safe to call at any pump boundary."""
        self.obs = obs
        if self.prefix_cache is not None:
            self.prefix_cache.obs = obs

    # ------------------------------------------------------------------
    # Device pieces
    # ------------------------------------------------------------------

    def _sample(self, lg: torch.Tensor) -> torch.Tensor:
        """Per-slot next token of a sampling chunk: top-k filtered
        temperature sampling where the slot's temperature is positive,
        argmax elsewhere.  Every slot draws from its own generator (the
        draws of greedy and idle slots go unused), so the draw is device
        data and a greedy row is its argmax whatever its neighbours do."""
        st = self._state
        greedy = torch.argmax(lg, dim=-1)
        V = lg.shape[-1]
        srt = torch.sort(lg, dim=-1, descending=True).values
        kth = torch.gather(
            srt, 1, (st.top_k - 1).clamp(0, V - 1)[:, None].long())[:, 0]
        keep = (st.top_k <= 0)[:, None] | (lg >= kth[:, None])
        filt = torch.where(keep, lg, torch.full_like(lg, -float("inf")))
        probs = torch.softmax(filt / st.temp.clamp(min=1e-6)[:, None], -1)
        # exponential race: argmax(p / E) with E ~ Exp(1) draws from p
        e = torch.stack([torch.empty_like(probs[s]).exponential_(generator=g)
                         for s, g in enumerate(self._slot_gen)])
        return torch.where(st.temp > 0, torch.argmax(probs / e, dim=-1),
                           greedy)

    @staticmethod
    def _greedy(lg: torch.Tensor) -> torch.Tensor:
        """Per-slot next token of a greedy-only chunk."""
        return torch.argmax(lg, dim=-1)

    def _sketch_state(self, fold_base: torch.Tensor, tail: torch.Tensor
                      ) -> dict:
        return {"fold_base": fold_base, "tail": tail,
                "coeffs": self.tail_coeffs, "pos_hash": self.tail_pos_hash}

    def _attn_tables(self, tables: torch.Tensor) -> torch.Tensor:
        """The model's view of block tables (B, blocks_per_slot) or a row:
        the first ``attn_blocks`` entries."""
        if tables.shape[-1] == self.attn_blocks:
            return tables
        return tables[..., :self.attn_blocks].contiguous()

    def _pools(self) -> List[dict]:
        """The paged caches {"kv", ("tail")}: the target's, then the
        draft's in a spec engine."""
        c = self._state.cache
        return [c] + ([c["draft"]] if self.draft is not None else [])

    def _prefill_variants(self) -> List[PrefillVariant]:
        """The prefill variants this engine can run: the sketch-free
        chunk, and on a sketched engine the two-span chunk of a slot that
        has folded rows.  A recurrent engine has none: it prefills
        eagerly."""
        if not self.is_kv:
            return []
        return [PrefillVariant(False)] + (
            [PrefillVariant(True)] if self.sketch_on else [])

    def _usable_variants(self) -> List[Variant]:
        """The chunk variants this engine can dispatch."""
        return [Variant(sampled, sketched) for sketched in
                ((False, True) if self.sketch_on else (False,))
                for sampled in (False, True)]

    def _variant(self, fold: Optional[np.ndarray]) -> Variant:
        """The host's choice for the coming chunk, from its mirrors: the
        full sampler if a live slot samples, the two-span attention if a
        live slot attends a folded tail after this dispatch's fold."""
        live = [s for s, r in enumerate(self._slot_req) if r is not None]
        sketched = fold is not None and any(
            self._slot_first_lblk[s] * self.block_size + fold[s]
            for s in live)
        return Variant(any(self._slot_temp[s] > 0.0 for s in live),
                       sketched)

    def _fold(self, fold: Optional[np.ndarray]) -> None:
        """A sketch engine folds ``fold[b]`` aged rows of each slot into
        its tail, in both pools of a spec engine (planned by
        ``_plan_folds``), eagerly ahead of the chunk: the folded rows lie
        below the window every query of the chunk keeps exact, so folding
        at the head equals folding between the steps."""
        if fold is None or not fold.any():
            return
        st = self._state
        fold_len = self._to_device(fold)
        for c in self._pools():
            kvs.fold_pool(c["kv"], c["tail"], st.tables, st.fold_base,
                          fold_len, self.tail_coeffs, self.fold_cap,
                          use_kernel=self.use_kernels)
        st.fold_base.add_(fold_len)

    def _chunk(self, v: Variant) -> torch.Tensor:
        """Enqueue ``decode_chunk`` decode steps (a spec engine: rounds,
        serve/speculative.py) for every slot: the device program of one
        variant, reading only tensors of the slot state whose addresses
        never change, so it can be captured once and replayed.  Returns
        the stacked (2, chunk, B) — spec: (2, chunk, B, K + 1) — int64
        tokens and emit flags, on the device."""
        cfg, st = self.cfg, self._state
        sample = self._sample if v.sampled else self._greedy
        sketch = draft_sketch = None
        if v.sketched:
            sketch, draft_sketch = ([
                self._sketch_state(st.fold_base, c["tail"])
                for c in self._pools()] + [None])[:2]
        tables = self._attn_tables(st.tables) if self.is_kv else None
        rows = self.step_rows if self.is_kv else None
        if self.spec_max > 0:
            return spec.spec_chunk(
                self.params, self.draft, cfg, st, tables,
                self.serve.decode_chunk, self.spec_max, sample,
                self.step_rows, kernels=self.use_kernels, sketch=sketch,
                draft_sketch=draft_sketch)
        toks, emits = [], []
        for _ in range(self.serve.decode_chunk):
            running = st.remaining > 0
            logits, _ = tf.decode_step(self.params, st.cache, st.cur, st.pos,
                                       cfg, tables,
                                       kernels=self.use_kernels,
                                       sketch=sketch, rows=rows)
            nxt = sample(logits[:, :cfg.vocab_size])
            step = running.to(torch.int32)
            st.pos.add_(step)
            st.remaining.sub_(step)
            st.cur.copy_(nxt[:, None])
            toks.append(nxt)
            emits.append(running.to(torch.int64))
        return torch.stack([torch.stack(toks), torch.stack(emits)])

    # ------------------------------------------------------------------
    # Scheduling
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        sv = self.serve
        S = len(req.tokens)
        if req.max_new < 1 or S < 1:
            raise ValueError("requests need a prompt and at least one "
                             "output token")
        if S + req.max_new > sv.max_seq:
            raise ValueError(f"prompt {S} + max_new {req.max_new} exceeds "
                             f"max_seq {sv.max_seq}")
        if self.is_kv:
            self._check_pool_fits(req)
        self._enqueue(req, front=False)
        if self.obs is not None:
            self.obs.request_queued(req.rid, S, req.priority)

    def _check_pool_fits(self, req: Request) -> None:
        """Reject up front what the pool can never serve, so it can't
        head-of-line-block the queue."""
        S = len(req.tokens)
        bs = self.block_size
        need = -(-(S + req.max_new + self.spec_overhang) // bs)
        if self.sketch_on and req.kv_sketch is not False:
            # a sketched request never holds its whole context: its peak
            # is the exact window + one prefill bucket of write frontier +
            # one chunk of decode lookahead (+ speculative overhang)
            peak = (self.kv_window // bs + -(-self.prefill_bucket // bs)
                    + -(-(self.adv_max + self.spec_overhang) // bs) + 2)
            need = min(need, peak)
        if need > self.num_blocks:
            raise ValueError(f"request needs {need} KV blocks of "
                             f"{self.block_size}, pool has "
                             f"{self.num_blocks} (raise num_kv_blocks)")

    def _enqueue(self, req: Request, front: bool) -> None:
        """Priority-ordered insertion (descending priority, FIFO within a
        band); ``front`` inserts at the head of the request's band (for
        preempted continuations)."""
        pr = req.priority
        if front:
            i = 0
            while i < len(self._queue) and self._queue[i].priority > pr:
                i += 1
        else:
            i = len(self._queue)
            while i > 0 and self._queue[i - 1].priority < pr:
                i -= 1
        self._queue.insert(i, req)

    def _seed_slot_generator(self, slot: int, req: Request) -> None:
        """Start ``slot``'s generator where the request's draws start:
        ``req.generator``'s state, else its seed, else the base seed plus
        the rid."""
        g = self._slot_gen[slot]
        if req.generator is not None:
            g.set_state(req.generator.get_state())
        else:
            g.manual_seed(req.seed if req.seed is not None
                          else self._base_seed + req.rid)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device without waiting on the stream (pinned,
        non-blocking copy), so admission overlaps a chunk in flight."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _stage_prefill(self, tok: np.ndarray, row: np.ndarray, off: int,
                       fold_base: int, slot: int) -> None:
        """Write one chunk's values into the static prefill inputs without
        waiting on the stream: one copy from a fresh pinned tensor per
        chunk, as ``_to_device`` makes them, since the copy may still be
        queued behind a chunk in flight when the host stages the next
        one."""
        a = np.concatenate([tok.reshape(-1), row, [off, fold_base, slot]])
        self._pf.buf.copy_(self._to_device(a.astype(np.int64)),
                           non_blocking=True)

    def _chunk_prefill_loop(self, prompt: np.ndarray, row: np.ndarray,
                            start_off: int, slot: int) -> None:
        """Feed prompt rows [start_off, S) through bucket-sized prefill
        chunks over the slot's table ``row``.  Starts are always absolute
        bucket multiples, so a prefix-cache hit resuming mid-prompt replays
        exactly the chunk boundaries a cold miss used (overlap rows
        recompute to the values they hold) and both paths write the same
        cache rows."""
        S = len(prompt)
        bucket = self.prefill_bucket
        off = (start_off // bucket) * bucket
        while off < S:
            seg = prompt[off:off + bucket]
            tok = np.zeros((1, bucket), np.int64)
            tok[0, :len(seg)] = seg
            t0 = time.perf_counter()
            self._prefill_one(tok, row, off, slot)
            if self.obs is not None:
                self.obs.prefill_span(slot, off, len(seg),
                                      time.perf_counter() - t0)
            off += bucket

    def _prefill_one(self, tok: np.ndarray, row: np.ndarray, off: int,
                     slot: int = 0, fold_base: int = 0) -> None:
        """One prefill chunk: ``tok`` (1, bucket) at absolute row ``off``
        through the slot's (blocks_per_slot,) table ``row``; ``fold_base``
        > 0: the chunk attends the slot's folded span through its tails.
        The host stages the values into the static inputs, then replays
        the variant's graph (captured here at its first use) or, without
        graphs, runs the same chunk eagerly.  On the card CUDA events
        around the chunk time it (``prefill_ms``)."""
        v = PrefillVariant(fold_base > 0)
        self._stage_prefill(tok, row, off, fold_base, slot)
        pg = self._prefill_graphs
        if pg is not None:
            pg.ensure(v, lambda: self._prefill_static(v))
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        if pg is not None:
            pg.replay(v)
        else:
            self._prefill_static(v)
        if events is not None:
            events[1].record()
            self._prefill_events.append(events)

    def _prefill_static(self, v: PrefillVariant) -> None:
        """The prefill chunk of variant ``v`` on the static inputs alone,
        so it can be captured once and replayed: the target's pool and, in
        lockstep through the same table, the draft's, so a cached
        prefix's blocks hold both models' rows.  The two-span variant
        gathers the slot's tails by the static slot index (a copy of
        (2, L, 1, Z, C, K, hd) per pool, which the chunk only reads)."""
        p = self._pf
        table = self._attn_tables(p.table)
        fold_base = p.fold_base.to(torch.int32) if v.sketched else None
        models = [(self.params, self.cfg)]
        if self.draft is not None:
            models.append((self.draft.params, self.draft.cfg))
        for (params, cfg), c in zip(models, self._pools()):
            sketch = None
            if v.sketched:
                sketch = self._sketch_state(
                    fold_base, c["tail"].index_select(2, p.slot))
            tf.prefill_chunk(params, c, p.tokens, table, p.offset, cfg,
                             kernels=self.use_kernels, sketch=sketch)

    def _read_prefill_events(self, wait: bool = False) -> None:
        """Move the device times of finished prefill chunks into
        ``prefill_ms``; ``wait`` waits for the last one."""
        while self._prefill_events:
            a, b = self._prefill_events[0]
            if wait:
                b.synchronize()
            elif not b.query():
                break
            self.prefill_ms.append(a.elapsed_time(b))
            self._prefill_events.popleft()

    def prefill_chunk_ms(self) -> List[float]:
        """Device ms of every prefill chunk so far (waits for the last)."""
        self._read_prefill_events(wait=True)
        return list(self.prefill_ms)

    def _sketch_prefill_admit(self, slot: int, prompt: np.ndarray,
                              shared: List[int], start_off: int
                              ) -> Tuple[List[int], int, bool]:
        """Fold-through chunked prefill for a sketched request: blocks are
        allocated just ahead of the write frontier, and blocks that aged
        wholly past the exact window fold into the slot's tail tables and
        return to the pool, so a prompt's peak block hold is the window
        plus one prefill bucket, whatever its length.

        Returns (slot_ids, first_lblk, ok): the blocks still held (logical
        blocks [first_lblk, ...)), already unreffed when ok is False (the
        caller defers the admission)."""
        bs, W, NB = self.block_size, self.kv_window, self.num_blocks
        S = len(prompt)
        dev = self.device
        bucket = self.prefill_bucket
        row = np.full((self.blocks_per_slot,), NB, np.int32)
        slot_ids = list(shared)
        row[:len(slot_ids)] = slot_ids
        first_lblk = 0
        fold_base = 0
        off = (start_off // bucket) * bucket
        while off < S:
            seg = prompt[off:off + bucket]
            end = off + len(seg)                   # prompt rows fed so far
            need_end = (end - 1) // bs             # last logical block hit
            have_end = first_lblk + len(slot_ids) - 1
            if need_end > have_end:
                ids = self._take_blocks(need_end - have_end)
                if ids is None:
                    self.alloc.unref(slot_ids)
                    return [], 0, False
                row[have_end + 1:need_end + 1] = ids
                slot_ids.extend(ids)
            tok = np.zeros((1, bucket), np.int64)
            tok[0, :len(seg)] = seg
            t0 = time.perf_counter()
            self._prefill_one(tok, row, off, slot, fold_base)
            if self.obs is not None:
                self.obs.prefill_span(slot, off, len(seg),
                                      time.perf_counter() - t0)
            # fold whole blocks that aged past the window ([0, end) keeps
            # >= W exact rows; the decode resume row S-1 always stays
            # exact because fold_base <= S - W <= S - 1)
            n_elig = max(0, (end - W) // bs) - first_lblk
            while n_elig > 0:
                k = min(n_elig, self.prefill_fold_cap // bs)
                rows = self._to_device(row)[None]
                for c in self._pools():
                    kvs.fold_pool(
                        c["kv"], c["tail"][:, :, slot:slot + 1], rows,
                        torch.full((1,), fold_base, dtype=torch.int32,
                                   device=dev),
                        torch.full((1,), k * bs, dtype=torch.int32,
                                   device=dev),
                        self.tail_coeffs, self.prefill_fold_cap,
                        use_kernel=self.use_kernels)
                # sentinel the folded entries before freeing: a freed
                # block may be re-allocated while this row is live
                row[first_lblk:first_lblk + k] = NB
                dead = slot_ids[:k]
                del slot_ids[:k]
                self.alloc.unref(dead)
                first_lblk += k
                fold_base += k * bs
                self.fold_rows_total += k * bs
                if self.obs is not None:
                    self.obs.fold(slot, k * bs)
                n_elig -= k
            off += bucket
        return slot_ids, first_lblk, True

    def _take_blocks(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pool blocks, evicting idle prefix-cache entries
        under pressure; None when the pool can't serve it now."""
        ids = self.alloc.alloc(n)
        while ids is None and self.prefix_cache.evict_one(idle_only=True):
            ids = self.alloc.alloc(n)
        return ids

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy one physical block's rows, every layer of both pools."""
        for c in self._pools():
            for t in c["kv"].values():
                t[:, dst].copy_(t[:, src])

    def _ensure_exclusive(self, slot_ids: List[int], first_write: int,
                          first_lblk: int = 0) -> bool:
        """Copy-on-write fork: make every block of the slot that decode
        can write — logical blocks covering positions >= ``first_write``
        — held by the slot alone.  A shared block (a prefix-cache entry's
        or another slot's) is forked: a fresh block is taken (evicting
        idle cache entries under pressure), its rows copied in both pools,
        ``slot_ids`` rebound in place and the shared block loses this
        slot's reference.  False when the pool can't supply a fork target
        now (the caller unwinds and defers).  ``first_lblk`` is the
        logical block of ``slot_ids[0]`` (nonzero for a sketched slot
        whose leading blocks folded)."""
        bs = self.block_size
        for i in range(max(0, first_write // bs - first_lblk),
                       len(slot_ids)):
            b = slot_ids[i]
            nb = self.alloc.fork(b)
            while nb is None and self.prefix_cache.evict_one(idle_only=True):
                nb = self.alloc.fork(b)
            if nb is None:
                return False
            if nb != b:          # was shared: copy its rows
                self._copy_block(b, nb)
                slot_ids[i] = nb
                self.forks += 1
        return True

    def _admit(self, slot: int, req: Request) -> bool:
        """Try to admit ``req`` into ``slot``; False when the block pool
        can't reserve the request's KV now (it stays queued).  A recurrent
        engine always admits."""
        prompt = np.asarray(req.tokens, np.int32)
        S = len(prompt)
        st = self._state
        if self.is_kv:
            ok, hit = self._admit_kv(slot, req, prompt)
            if not ok:
                return False
        else:
            hit = None
            self._admit_recurrent(slot, prompt)
        temp = (self.temperature if req.temperature is None
                else float(req.temperature))
        eff_spec = 0
        if self.spec_max:
            eff_spec = (self.serve.spec_k if req.spec_k is None
                        else int(req.spec_k))
            eff_spec = max(0, min(eff_spec, self.spec_max))
        st.spec_k[slot] = eff_spec
        st.cur[slot, 0] = int(prompt[S - 1])
        st.pos[slot] = S - 1
        st.remaining[slot] = req.max_new
        st.temp[slot] = temp
        st.top_k[slot] = int(req.top_k)
        self._slot_pos[slot] = S - 1
        self._slot_req[slot] = req
        self._slot_out[slot] = []
        self._slot_hit[slot] = hit is not None
        self._slot_temp[slot] = temp
        if temp > 0.0:
            self._seed_slot_generator(slot, req)
        self._slot_admit_seq[slot] = self._admit_seq
        self._admit_seq += 1
        self._slot_spec[slot] = eff_spec if temp == 0.0 else 0
        if self.obs is not None:
            self.obs.request_admitted(req.rid, slot, hit is not None)
        return True

    def _admit_kv(self, slot: int, req: Request, prompt: np.ndarray
                  ) -> Tuple[bool, Optional[Tuple[int, Any]]]:
        """An attention family's half of ``_admit``: the prefix-cache hit,
        the slot's blocks, the chunked prefill and its table row.
        Returns (admitted, the prefix hit or None)."""
        S = len(prompt)
        bs = self.block_size
        st = self._state
        if req.rid not in self._admit_memo:
            hit = self.prefix_cache.lookup(prompt)
            self._admit_memo[req.rid] = self.prefix_cache.observe(prompt)
        else:
            # pool-pressure retry: counted on the first attempt already
            hit = self.prefix_cache.peek(prompt)
        admit_plen = self._admit_memo[req.rid]
        shared: List[int] = []
        start_off = 0
        if hit is not None:
            plen, ids = hit
            shared = list(ids)
            start_off = plen
            # pin the shared blocks before any allocation below can
            # pressure the cache into evicting (and freeing) them
            self.alloc.ref(shared)
        if admit_plen is not None and admit_plen <= start_off:
            admit_plen = None
        use_sketch = self.sketch_on and req.kv_sketch is not False
        first_lblk = 0
        if use_sketch:
            # the slot's tables may hold a retired occupant's sums
            for c in self._pools():
                c["tail"][:, :, slot].zero_()
            slot_ids, first_lblk, ok = self._sketch_prefill_admit(
                slot, prompt, shared, start_off)
            if not ok:
                if not any(r is not None for r in self._slot_req):
                    raise RuntimeError(
                        f"kv pool ({self.num_blocks} blocks of {bs}) too "
                        f"small for sketched prompt {S} with window "
                        f"{self.kv_window}")
                return False, None
        else:
            n_total = -(-(S + req.max_new + self.spec_overhang) // bs)
            new_ids = self._take_blocks(n_total - len(shared))
            if new_ids is None:
                if hit is not None:
                    self.alloc.unref(shared)
                if not any(r is not None for r in self._slot_req):
                    raise RuntimeError(
                        f"kv pool ({self.num_blocks} blocks of {bs}) too "
                        f"small for prompt {S} + max_new {req.max_new}")
                return False, None
            slot_ids = shared + new_ids
            row = np.full((self.blocks_per_slot,), self.num_blocks,
                          np.int32)
            row[:len(slot_ids)] = slot_ids
            st.tables[slot] = self._to_device(row)
            self._chunk_prefill_loop(prompt, row, start_off, slot)
        self._slot_blocks[slot] = slot_ids
        if admit_plen is not None and first_lblk > 0:
            # fold-through freed leading prompt blocks: the prefix's block
            # run no longer exists, and admitting the surviving suffix
            # would register freed (re-allocatable) ids as cache entries
            admit_plen = None
        if admit_plen is not None:
            self.prefix_cache.admit(prompt, admit_plen,
                                    tuple(slot_ids[:admit_plen // bs]))
        # copy-on-write (spec engines): plain decode's one write into a
        # shared block is the idempotent rewrite of the last prompt row,
        # but a verify step writes proposals that may be rejected, so a
        # speculating slot never writes a block with refcount > 1
        if self.spec_max and not self._ensure_exclusive(slot_ids, S - 1,
                                                        first_lblk):
            # pool exhausted mid-fork: drop the slot's references (the
            # cache keeps any entry admitted above) and defer; the memo
            # says admission already happened
            st.tables[slot] = self.num_blocks
            self.alloc.unref(slot_ids)
            self._slot_blocks[slot] = []
            self._admit_memo[req.rid] = None
            return False, None
        row = np.full((self.blocks_per_slot,), self.num_blocks, np.int32)
        row[first_lblk:first_lblk + len(slot_ids)] = slot_ids
        st.tables[slot] = self._to_device(row)
        st.fold_base[slot] = first_lblk * bs
        self._slot_first_lblk[slot] = first_lblk
        self._slot_use_sketch[slot] = use_sketch
        # demand: every row a live request attends, shared rows counted
        # per referencing request
        self._slot_rows[slot] = S + req.max_new
        self._used_rows += self._slot_rows[slot]
        self.peak_used_rows = max(self.peak_used_rows, self._used_rows)
        self._admit_memo.pop(req.rid, None)

        return True, hit

    def _admit_recurrent(self, slot: int, prompt: np.ndarray) -> None:
        """A recurrent family's half of ``_admit``: prefill the first
        S - 1 tokens at their exact length and copy the state into the
        slot in place (a 1-token prompt zeroes the slot), so every leaf of
        the slot is rewritten.  Decode consumes the last token: a
        recurrent step is not idempotent, so unlike a KV row it must run
        exactly once.  On the card CUDA events time the prefill
        (``prefill_ms``)."""
        S = len(prompt)
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        cache = self._state.cache
        if S > 1:
            tokens = self._to_device(prompt[None, :-1].astype(np.int64))
            _, pre = tf.prefill(self.params, tokens, self.cfg)
            # every leaf is (n, B, ...) in the slot state and (n, 1, ...)
            # in the prefill's; the hybrid KV holds only the S - 1 rows
            tf.tree_map(lambda dst, src: dst[:, slot, :src.shape[2]].copy_(
                src[:, 0]), cache, pre)
        else:
            tf.tree_map(lambda dst: dst[:, slot].zero_(), cache)
        if events is not None:
            events[1].record()
            self._prefill_events.append(events)

    def _complete(self, slot: int, status: str) -> Completion:
        """Completion for ``slot``'s occupant, folding in output emitted
        before an earlier preemption (original prompt_len, full output)."""
        req = self._slot_req[slot]
        out = list(self._slot_out[slot][:req.max_new])
        hit = self._slot_hit[slot]
        plen = len(req.tokens)
        stash = self._preempted.pop(req.rid, None)
        if stash is not None:
            plen, prior, hit0 = stash
            out = prior + out
            hit = hit or hit0
        return Completion(rid=req.rid, prompt_len=plen,
                          tokens=np.asarray(out, np.int32),
                          prefix_hit=hit, status=status)

    def _complete_queued(self, req: Request, status: str) -> Completion:
        """Completion for a request leaving the queue (cancelled or
        expired before admission)."""
        plen, prior, hit = self._preempted.pop(
            req.rid, (len(req.tokens), [], False))
        self._admit_memo.pop(req.rid, None)
        return Completion(rid=req.rid, prompt_len=plen,
                          tokens=np.asarray(prior, np.int32),
                          prefix_hit=hit, status=status)

    def _release_slot_state(self, freed: List[int],
                            deactivate: bool = False) -> None:
        """Release every slot in ``freed`` — device table rows, pool
        blocks, host mirrors.  ``deactivate`` also zeroes the device
        ``remaining`` (mid-flight evictions)."""
        for s in freed:
            if deactivate:
                self._state.remaining[s] = 0
            req = self._slot_req[s]
            if self._slot_temp[s] > 0.0 and req.generator is not None:
                # the caller's generator ends where the slot's draws left
                # it, as if the slot had drawn from it
                req.generator.set_state(self._slot_gen[s].get_state())
            if self.is_kv:
                # sentinel the row BEFORE its blocks can be freed and
                # reused: an idle slot still runs the decode write every
                # step (a recurrent slot's state is rewritten whole at its
                # next admission instead)
                self._state.tables[s] = self.num_blocks
                # the fold frontier resets with the slot; the tail sums
                # are zeroed at the next admission
                self._state.fold_base[s] = 0
                self.alloc.unref(self._slot_blocks[s])
            self._slot_first_lblk[s] = 0
            self._slot_use_sketch[s] = False
            self._slot_pos[s] = 0
            self._slot_blocks[s] = []
            self._used_rows -= self._slot_rows[s]
            self._slot_rows[s] = 0
            self._slot_req[s] = None
            self._slot_out[s] = []
            self._slot_temp[s] = 0.0
            self._slot_spec[s] = 0

    def _retire(self) -> List[Completion]:
        """Retire every slot whose collected output reached ``max_new``."""
        done: List[Completion] = []
        freed: List[int] = []
        for s, req in enumerate(self._slot_req):
            if req is not None and len(self._slot_out[s]) >= req.max_new:
                done.append(self._complete(s, "ok"))
                freed.append(s)
        self._release_slot_state(freed)
        self.completed.extend(done)
        if self.obs is not None:
            for c in done:
                self.obs.request_finished(c.rid, c.status, len(c.tokens))
        return done

    def cancel(self, rid: int, status: str = "cancelled"
               ) -> Optional[Completion]:
        """Cancel a queued or in-flight request (pump boundary only): a
        queued one leaves the queue, an admitted one is evicted and its
        blocks unreffed.  Returns the Completion (partial tokens) or None
        for an unknown rid."""
        assert self._inflight is None, (
            "cancel() between dispatch() and collect()")
        comp = None
        for i, r in enumerate(self._queue):
            if r.rid == rid:
                self._queue.pop(i)
                comp = self._complete_queued(r, status)
                break
        if comp is None:
            for s, r in enumerate(self._slot_req):
                if r is not None and r.rid == rid:
                    comp = self._complete(s, status)
                    self._release_slot_state([s], deactivate=True)
                    break
        if comp is None:
            return None
        if status == "expired":
            self.expirations += 1
        else:
            self.cancellations += 1
        self.completed.append(comp)
        if self.obs is not None:
            self.obs.request_finished(comp.rid, comp.status,
                                      len(comp.tokens))
        return comp

    def expire_deadlines(self, now: Optional[float] = None
                         ) -> List[Completion]:
        """Expire every request whose deadline has passed (queued ones
        with empty output, in-flight ones with what they have)."""
        if now is None:
            now = time.monotonic()
        late = [r.rid for r in self._queue
                if r.deadline is not None and r.deadline <= now]
        late += [r.rid for r in self._slot_req
                 if r is not None and r.deadline is not None
                 and r.deadline <= now]
        return [c for c in (self.cancel(rid, "expired") for rid in late)
                if c is not None]

    def preempt(self, slot: int) -> Request:
        """Evict a running slot and requeue its request as a continuation
        (prompt + tokens so far, budget reduced) at the head of its
        priority band.  A sampled slot's continuation draws on from where
        the slot's generator stands.  Pump boundary only."""
        assert self._inflight is None, (
            "preempt() between dispatch() and collect()")
        req = self._slot_req[slot]
        assert req is not None, f"preempt of empty slot {slot}"
        out = list(self._slot_out[slot])
        plen0, prior, hit0 = self._preempted.get(
            req.rid, (len(req.tokens), [], False))
        self._preempted[req.rid] = (plen0, prior + out,
                                    hit0 or self._slot_hit[slot])
        gen = req.generator          # the release below hands it the state
        if self._slot_temp[slot] > 0.0 and gen is None:
            gen = torch.Generator(device=self.device)
            gen.set_state(self._slot_gen[slot].get_state())
        cont = dataclasses.replace(
            req,
            tokens=np.concatenate([np.asarray(req.tokens, np.int32),
                                   np.asarray(out, np.int32)]),
            max_new=req.max_new - len(out), generator=gen)
        self._release_slot_state([slot], deactivate=True)
        self.preemptions += 1
        if self.obs is not None:
            self.obs.request_preempted(req.rid, slot, len(out))
        # the continuation must not re-feed the count-min tracker
        self._admit_memo[req.rid] = None
        self._enqueue(cont, front=True)
        return cont

    def _preempt_for(self, req: Request) -> Optional[int]:
        """Evict the lowest-priority running slot strictly below
        ``req``'s priority (ties toward the most recently admitted);
        None when preemption is off or no slot qualifies."""
        if not self.serve.preemption:
            return None
        best = None
        for s, r in enumerate(self._slot_req):
            if r is None or r.priority >= req.priority:
                continue
            rank = (r.priority, -self._slot_admit_seq[s])
            if best is None or rank < best[0]:
                best = (rank, s)
        if best is None:
            return None
        self.preempt(best[1])
        return best[1]

    @property
    def pending(self) -> bool:
        """True while any request is queued or occupying a slot."""
        return bool(self._queue) or any(
            r is not None for r in self._slot_req)

    @property
    def queue_len(self) -> int:
        return len(self._queue)

    def progress(self) -> Dict[int, List[int]]:
        """rid -> tokens emitted so far, for every request still queued or
        in flight (a preempted request's earlier output counts)."""
        out: Dict[int, List[int]] = {}
        for rid, (_, prior, _) in self._preempted.items():
            out[rid] = list(prior)
        for s, r in enumerate(self._slot_req):
            if r is not None:
                out[r.rid] = out.get(r.rid, []) + list(self._slot_out[s])
        for r in self._queue:
            out.setdefault(r.rid, [])
        return out

    def _plan_folds(self) -> np.ndarray:
        """Pre-chunk bookkeeping for sketched slots: allocate the blocks
        the coming chunk can write (a sketched slot never reserves its
        whole context) and decide how many rows each slot folds into its
        tail at the chunk head.  Returns the per-slot fold length (rows,
        block multiples); ``_finish_folds`` frees the folded blocks after
        the chunk is enqueued.  Reads only host mirrors."""
        bs, W = self.block_size, self.kv_window
        fold = np.zeros((self.serve.max_batch,), np.int32)
        for s, req in enumerate(self._slot_req):
            if req is None or not self._slot_use_sketch[s]:
                continue
            p = self._slot_pos[s]
            first = self._slot_first_lblk[s]
            held = self._slot_blocks[s]
            # the chunk writes rows up to p + adv_max (+ rejected
            # speculative writes), clamped to the request's own demand
            last = min(p + self.adv_max, self._slot_rows[s] - 1) \
                + self.spec_overhang
            need_end = min(last // bs, self.blocks_per_slot - 1)
            have_end = first + len(held) - 1
            if need_end > have_end:
                ids = self._take_blocks(need_end - have_end)
                if ids is None:
                    raise RuntimeError(
                        f"kv pool exhausted extending sketched slot {s} "
                        f"(pool {self.num_blocks} blocks of {bs}; raise "
                        f"num_kv_blocks or shrink kv_sketch_window)")
                self._state.tables[s, have_end + 1:need_end + 1] = \
                    self._to_device(np.asarray(ids, np.int32))
                held.extend(ids)
            # fold whole blocks aged past the exact window, at most the
            # chunk's fold span
            n = min(max(0, (p + 1 - W) // bs - first), self.fold_cap // bs,
                    len(held))
            fold[s] = n * bs
        return fold

    def _finish_folds(self, fold: np.ndarray) -> None:
        """Post-chunk half of a fold: the chunk folded the rows and
        advanced ``fold_base``; the blocks now leave the slot — table
        entries sentineled first (enqueued after the chunk), then the
        references dropped."""
        dead: List[int] = []
        for s in range(self.serve.max_batch):
            n = int(fold[s]) // self.block_size
            if n == 0:
                continue
            first = self._slot_first_lblk[s]
            self._state.tables[s, first:first + n] = self.num_blocks
            dead.extend(self._slot_blocks[s][:n])
            del self._slot_blocks[s][:n]
            self._slot_first_lblk[s] = first + n
            self.fold_rows_total += n * self.block_size
            if self.obs is not None:
                self.obs.fold(s, n * self.block_size)
        self.alloc.unref(dead)

    # ------------------------------------------------------------------
    # Pump phases
    # ------------------------------------------------------------------

    def admit_pending(self) -> int:
        """Move queued requests into free slots until the queue empties,
        the engine fills or the pool can't serve the head request; a full
        engine may preempt a strictly lower-priority slot for a
        higher-priority head.  Safe while a chunk is in flight."""
        admitted = 0
        while self._queue:
            head = self._queue[0]
            slot = next((s for s, r in enumerate(self._slot_req)
                         if r is None), None)
            if slot is None:
                slot = self._preempt_for(head) \
                    if self._inflight is None else None
            if slot is None or not self._admit(slot, head):
                if slot is not None and self.obs is not None:
                    # a free slot existed but the pool couldn't serve the
                    # head request now: a deferral stall
                    self.obs.admission_deferred(head.rid)
                break
            self._queue.pop(0)
            admitted += 1
        return admitted

    def dispatch(self) -> bool:
        """Launch one decode chunk: the eager fold at its head, then the
        variant's graph replay (captured here at the variant's first
        dispatch) or, without graphs, the eager chunk.  On the card this
        only enqueues work; ``collect()`` waits for it.  False when no
        slot is active."""
        assert self._inflight is None, "one decode chunk may be in flight"
        if not any(r is not None for r in self._slot_req):
            return False
        fold = self._plan_folds() if self.sketch_on else None
        v = self._variant(fold)
        if self._graphs is not None:
            self._graphs.ensure(v, lambda: self._chunk(v))
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        self._fold(fold)
        out = (self._graphs.replay(v) if self._graphs is not None
               else self._chunk(v))
        if events is not None:
            events[1].record()
        if fold is not None:
            self._finish_folds(fold)
        self.decode_steps += self.serve.decode_chunk
        self._inflight = (out, events)
        return True

    def collect(self) -> List[Completion]:
        """Copy the chunk's tokens to the host (the round's one wait on
        the device), account them to their slots and retire finished
        requests.  Slots admitted while the chunk was in flight emitted
        nothing (their ``remaining`` was 0 when it was enqueued)."""
        assert self._inflight is not None, "collect() without dispatch()"
        out, events = self._inflight
        self._inflight = None
        host = out.cpu().numpy()
        if events is not None:
            self.chunk_ms.append(events[0].elapsed_time(events[1]))
            self._read_prefill_events()
        toks, emits = host[0], host[1].astype(bool)
        if toks.ndim == 2:               # plain chunk: one token per step
            toks, emits = toks[:, :, None], emits[:, :, None]
        round_tokens = 0
        for t in range(toks.shape[0]):
            for s in range(toks.shape[1]):
                if self._slot_req[s] is None:
                    continue
                e = int(emits[t, s].sum())
                if e == 0:
                    continue
                self._slot_out[s].extend(int(x) for x in
                                         toks[t, s][emits[t, s]])
                self._slot_pos[s] += e
                round_tokens += e
                # one verify round: spec_k proposed, e - 1 survived
                rr, pp, aa = spec.round_accounting(self._slot_spec[s], e)
                if rr:
                    self.spec_rounds += rr
                    self.spec_proposed += pp
                    self.spec_accepted += aa
                    if self.obs is not None:
                        self.obs.spec_round(self._slot_req[s].rid, pp, aa)
        done = self._retire()
        if self.obs is not None:
            self._round_idx += 1
            self.obs.chunk_collected(
                round_tokens, len(self._queue),
                sum(r is not None for r in self._slot_req))
            if (self.sketch_on and self.obs.fidelity_every > 0
                    and self._round_idx % self.obs.fidelity_every == 0):
                self._probe_fidelity()
            self.obs.maybe_flush(self.stats)
        return done

    def _probe_fidelity(self) -> None:
        """Opt-in sketch-fidelity probe: per-slot relative spread of the Z
        hash rows' tail energies (``kv_sketch.tail_row_spread`` over the
        target's stacked tails), reported for every sketched slot that
        has folded rows.  It runs only here, after the round's tokens
        reached the host, and only at the observer's ``fidelity_every``
        cadence, on the stream the replays use, so it orders after the
        round's folds and any prefill launched meanwhile; the captured
        chunks are untouched."""
        sp = kvs.tail_row_spread(self._state.cache["tail"]).cpu().numpy()
        for s, req in enumerate(self._slot_req):
            if req is None or not self._slot_use_sketch[s]:
                continue
            folded = self._slot_first_lblk[s] * self.block_size
            if folded <= 0:
                continue
            self.obs.fidelity(s, req.rid, folded, float(sp[s]))

    def step(self) -> List[Completion]:
        """One synchronous round: expire, admit, dispatch, collect."""
        self.expire_deadlines()
        self.admit_pending()
        if not self.dispatch():
            return []
        return self.collect()

    def drain(self) -> List[Completion]:
        """Step until every queued and in-flight request completed."""
        done: List[Completion] = []
        while self.pending:
            done.extend(self.step())
        return done

    def run(self, requests: Optional[List[Request]] = None
            ) -> List[Completion]:
        """Closed batch: submit ``requests`` (if given) and drain."""
        for r in requests or []:
            self.submit(r)
        return self.drain()

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def decode_compilations(self) -> int:
        """Decode chunk variants captured as CUDA graphs (0 when the chunk
        runs eagerly)."""
        return 0 if self._graphs is None else self._graphs.captures

    @property
    def prefill_compilations(self) -> int:
        """Prefill chunk variants captured as CUDA graphs (0 when prefill
        runs eagerly): 1 on a sketch-free engine, at most 2 on a sketched
        one, 0 on a recurrent one (its prefill is eager)."""
        return (0 if self._prefill_graphs is None
                else self._prefill_graphs.captures)

    def kv_cache_bytes(self) -> int:
        """Bytes of the slot cache: the whole pool (and tails, and a spec
        engine's draft pool) of an attention family, the stacked
        recurrent state otherwise."""
        leaves: List[torch.Tensor] = []
        tf.tree_map(leaves.append, self._state.cache)
        return sum(t.numel() * t.element_size() for t in leaves)

    def kv_reserved_bytes(self) -> int:
        """Bytes of pool blocks currently allocated (slots + cache); a
        recurrent engine's whole state."""
        if not self.is_kv:
            return self.kv_cache_bytes()
        return self.alloc.reserved_bytes()

    def kv_peak_reserved_bytes(self) -> int:
        if not self.is_kv:
            return self.kv_cache_bytes()
        return self.alloc.peak_reserved_bytes()

    def kv_peak_used_bytes(self) -> int:
        """High-water mark of the KV row demand of live requests."""
        if not self.is_kv:
            return self.kv_cache_bytes()
        row_bytes = self.alloc.block_bytes / self.block_size
        return int(row_bytes * self.peak_used_rows)

    def kv_dense_equiv_bytes(self) -> int:
        """Bytes a dense (L, max_batch, max_seq, K, hd) cache would hold."""
        if not self.is_kv:
            return self.kv_cache_bytes()
        row_bytes = self.alloc.block_bytes / self.block_size
        return int(row_bytes * self.serve.max_seq * self.serve.max_batch)

    def kv_sketch_tail_bytes(self) -> int:
        """Bytes of the per-slot FCS tail tables: the fixed cost that
        replaces exact-KV growth past the window (0 without sketching)."""
        if not self.sketch_on:
            return 0
        return sum(kvs.tail_state_bytes(c["tail"]) for c in self._pools())

    def kv_sketch_exact_bytes(self) -> int:
        """Bytes of pool blocks held now by sketched slots: the exact
        recent-window span of the two-span cache."""
        if not self.sketch_on:
            return 0
        return sum(len(self._slot_blocks[s]) * self.alloc.block_bytes
                   for s in range(self.serve.max_batch)
                   if self._slot_use_sketch[s])

    def stats(self) -> EngineStats:
        """The unified snapshot.  A recurrent engine's pool, KV byte and
        prefix fields stay 0, as in the reference."""
        st = EngineStats(
            queue_depth=len(self._queue),
            active_slots=sum(r is not None for r in self._slot_req),
            max_batch=self.serve.max_batch,
            completed=len(self.completed),
            cancelled=self.cancellations,
            expired=self.expirations,
            preempted=self.preemptions,
            decode_steps=self.decode_steps,
            decode_compilations=self.decode_compilations,
            prefill_compilations=self.prefill_compilations,
            fold_rows=self.fold_rows_total,
            kv_sketch_tail_bytes=self.kv_sketch_tail_bytes(),
            spec_rounds=self.spec_rounds,
            spec_proposed=self.spec_proposed,
            spec_accepted=self.spec_accepted,
        )
        if self.is_kv:
            pc = self.prefix_cache.stats
            st.pool_blocks = self.num_blocks
            st.block_size = self.block_size
            st.blocks_reserved = self.alloc.reserved
            st.blocks_free = self.alloc.free_count
            st.blocks_peak = self.alloc.peak_reserved
            st.kv_reserved_bytes = self.kv_reserved_bytes()
            st.kv_peak_reserved_bytes = self.kv_peak_reserved_bytes()
            st.kv_peak_used_bytes = self.kv_peak_used_bytes()
            st.kv_dense_equiv_bytes = self.kv_dense_equiv_bytes()
            st.prefix_lookups = pc.lookups
            st.prefix_hits = pc.hits
            st.prefix_admitted = pc.admitted
            st.prefix_evicted = pc.evicted
            st.prefix_cached_bytes = pc.bytes
        return st
