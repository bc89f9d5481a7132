"""The decode chunk and the prefill chunk captured once and replayed: the
port's form of the reference's one decode and one prefill compilation per
engine (``jax.jit`` of the decode scan or of the speculative round, and of
the offset-traced prefill chunk, ``repro/serve/scheduler.py``, counted by
``decode_compilations`` and ``prefill_compilations``).

On the card a ``SlotScheduler`` records each variant of its decode chunk
(``SlotScheduler._chunk``: ``decode_chunk`` plain steps or speculative
rounds) as a CUDA graph at the variant's first dispatch and replays that
graph on every later dispatch of the variant.  A variant is what the host
still decides per dispatch: whether any live slot samples (the sampler's
sort and draws, or an argmax alone) and whether any live slot attends a
folded tail (the two-span attention, or the sketch-free one).  An engine
has at most four; they share one private memory pool.  The eager chunk
stays the CPU path and the card's twin (``graphs=False``).

The prefill chunk (``SlotScheduler._prefill_static``: one prompt chunk of
one slot through the target's pool and, in the same graph, the draft's)
is captured the same way, in a second ``ChunkGraphs`` with a private pool
of its own.  Its variant is whether the chunk attends a folded tail: a
sketch-free engine has one, a sketched engine two.  It reads only static
inputs that the host writes before each replay (tokens, table row,
offset, fold base, slot), and the two-span variant gathers the slot's
tails by the static slot index inside the graph.  The pools are separate
because the front end prefills while a decode chunk is in flight: that
chunk's static output is read only at the later ``collect``, and a
prefill replay whose intermediates reused its memory would overwrite
tokens the host has not read yet.

Capture records the work and executes nothing, which shapes the chunks:

* Every lazy first call happens before capture: the scheduler runs each
  variant it can use once eagerly at construction, while every slot is
  idle (the kernels' shared-memory opt-ins, cuBLAS workspaces, the
  libraries' first loads, cached hash tables); a prefill variant runs on
  a table row of sentinels, so its KV writes land in the write sink.
* A chunk reads only tensors whose addresses never change (the slot
  state, the prefill's static inputs, the pools and tails, the weights).
  The decode chunk writes its tokens and emit flags into one static
  output, which ``collect`` copies before the next replay overwrites it;
  the prefill chunk writes only the pools.  Folds of aged rows run
  eagerly between replays.
* Draws come from the engine's per-slot generators, registered with every
  decode graph: a replay reads each generator's state on the host and
  advances it by what the captured draws take, as eager draws would.
* The kernel wrappers count their launches in Python, which runs once, at
  capture.  Each variant's counts are taken at capture, taken back there
  (nothing was launched) and added at every replay, so a graphed stream
  counts what its eager twin counts.

``torch.cuda.graph`` captures in the "global" error mode: no other thread
may make a synchronizing CUDA call meanwhile.  The front end's collect
thread is idle then, since a capture happens inside ``dispatch`` or
``admit_pending`` and the front end awaits ``collect`` only after both.
Nor may the capturing thread destroy a CUDA graph, which the cyclic
garbage collector would do if it freed a discarded engine (the front
end's pump task holds its engine in a reference cycle) during a capture;
``torch.cuda.graph`` no longer collects before it begins, so the
collector is off while a capture runs.
A capture synchronizes as it begins, so a prefill variant first used
while a decode chunk is in flight waits once for that chunk.  A failed
capture or replay raises; nothing falls back to the eager chunk.
"""
from __future__ import annotations

import gc
import time
from typing import (Callable, Dict, Hashable, List, NamedTuple, Optional,
                    Sequence)

import torch

from repro_torch.kernels.count_sketch import count_sketch, unsketch
from repro_torch.kernels.kv_sketch import tail_fold, tail_scores
from repro_torch.kernels.paged_attention import paged_attention


class Variant(NamedTuple):
    sampled: bool      # some live slot samples: the full sampler runs
    sketched: bool     # some live slot attends a folded tail

    @property
    def name(self) -> str:
        return (("sampled" if self.sampled else "greedy")
                + ("+sketched" if self.sketched else ""))


class PrefillVariant(NamedTuple):
    sketched: bool     # the chunk attends the slot's folded tail

    @property
    def name(self) -> str:
        return "prefill" + ("+sketched" if self.sketched else "")


def launch_counters() -> tuple:
    """The kernel wrappers a decode or prefill chunk can reach, each
    counting its launches in ``.launches``."""
    return (paged_attention, tail_fold, tail_scores, count_sketch, unsketch)


class CudaChunkGraph:
    """One variant's chunk recorded as a CUDA graph in ``pool`` (None: a
    new private pool), with the given generators registered; ``replay``
    runs it and returns the static output ``fn`` produced at capture
    (None for a prefill chunk, which writes only the pools)."""

    def __init__(self, fn: Callable[[], Optional[torch.Tensor]],
                 generators: Sequence[torch.Generator], pool):
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = fn()

    def replay(self) -> Optional[torch.Tensor]:
        self.graph.replay()
        return self.out

    def pool(self):
        return self.graph.pool()


class ChunkGraphs:
    """An engine's captured chunk variants of one kind (decode, keyed by
    ``Variant``, or prefill, by ``PrefillVariant``): each captured at its
    first use (``ensure``) and replayed after (``replay``), all in one
    memory pool private to this instance.  ``capture`` builds a variant's
    graph from (fn, generators, pool); tests pass a stand-in."""

    def __init__(self, generators: Sequence[torch.Generator],
                 capture: Callable = CudaChunkGraph):
        self.generators = list(generators)
        self._capture = capture
        self._pool = None
        self._graphs: Dict[Hashable, tuple] = {}
        self.capture_s: Dict[Hashable, float] = {}
        self.replays: Dict[Hashable, int] = {}

    @property
    def captures(self) -> int:
        """Graph captures so far: the engine's ``decode_compilations`` or
        ``prefill_compilations``."""
        return len(self._graphs)

    def ensure(self, variant: Hashable,
               fn: Callable[[], Optional[torch.Tensor]]) -> None:
        """Capture ``fn``, the variant's chunk, unless already captured."""
        if variant in self._graphs:
            return
        counters = launch_counters()
        before = [w.launches for w in counters]
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph = self._capture(fn, self.generators, self._pool)
        finally:
            if collecting:
                gc.enable()
        self.capture_s[variant] = time.perf_counter() - t0
        delta = [w.launches - b for w, b in zip(counters, before)]
        for w, b in zip(counters, before):
            w.launches = b               # the capture launched nothing
        if self._pool is None:
            self._pool = graph.pool()
        self._graphs[variant] = (graph, delta)

    def replay(self, variant: Hashable) -> Optional[torch.Tensor]:
        """Run the captured variant; returns its static output."""
        graph, delta = self._graphs[variant]
        out = graph.replay()
        for w, n in zip(launch_counters(), delta):
            w.launches += n
        self.replays[variant] = self.replays.get(variant, 0) + 1
        return out

    def pool_bytes(self) -> int:
        """Bytes of the card's memory segments in this instance's pool (0
        before the first capture)."""
        if self._pool is None:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(
                       self._pool))

    def variants(self) -> List[Hashable]:
        """The captured variants, in capture order."""
        return list(self._graphs)
