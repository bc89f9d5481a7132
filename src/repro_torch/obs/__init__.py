"""Serve-path observability of the port (its own copy of ``repro/obs``):
request tracing, windowed metrics and sketch-fidelity telemetry.

Layering::

    trace.py    Chrome trace-event recorder (sampled, bounded, host-only)
    metrics.py  counter / gauge / log-bucket-histogram registry with
                windowed (interval-delta) snapshots
    export.py   trace JSON + metrics JSONL + Prometheus text sinks
    __init__    ServeObserver — the one object the serve layer talks to

The serve layer (``repro_torch.serve``) never imports trace/metrics/
export directly: the scheduler, its prefix cache and the async front-end
hold an optional ``obs`` attribute (a ``ServeObserver`` or ``None``) and
guard every hook with ``if self.obs is not None`` — observability off
costs one attribute check per site.  Every hook takes host values the
pump already holds (mirrors, counters, ``time.perf_counter()``
durations), so observing adds no device sync; nothing here imports
torch.  The one exception is the opt-in sketch-fidelity probe, which
the scheduler runs at ``collect()``, after the round's copy to the host,
and only at its configured cadence.

On the card the decode and prefill chunks replay CUDA graphs: every hook
sits in the host code around ``dispatch()`` / ``collect()`` and each
prefill chunk's launch, never inside a captured body (which would run
once, at capture).  A ``prefill_chunk`` span is the host's cost of
staging and launching the chunk (a replay), not its device time, which
``SlotScheduler.prefill_chunk_ms()`` measures with CUDA events; the first
span of each variant includes its capture.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Set, Union

from repro_torch.obs.export import (MetricsJsonlWriter, prometheus_text,
                                    write_trace)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "MetricsJsonlWriter", "ServeObserver", "Tracer",
    "prometheus_text", "write_trace",
]

_MAX_WINDOWS = 512          # retained in-memory snapshots (tests, CLI)


class ServeObserver:
    """Facade bundling one tracer + one metrics registry + one JSONL
    sink behind the semantic hooks the serve layer calls.

    Construction knobs:
      ``tracer``            a ``Tracer`` or None (tracing off)
      ``registry``          shared ``MetricsRegistry`` (default: fresh)
      ``metrics_path``      JSONL file for windowed snapshots, or None
      ``metrics_interval``  seconds between windows flushed by
                            ``maybe_flush`` (<= 0: flush every call)
      ``fidelity_every``    sketch-fidelity probe cadence in decode
                            rounds (0 = probe off; see
                            ``kv_sketch.tail_row_spread``)

    Thread-safety note: hooks append to python lists/dicts from the
    pump task and from ``collect()`` running in a worker thread, but
    never concurrently — the pump awaits the collect thread, so at most
    one of them is inside the observer at a time.
    """

    def __init__(self, tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 metrics_path: Optional[str] = None,
                 metrics_interval: float = 0.5,
                 fidelity_every: int = 0):
        self.tracer = tracer
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.metrics_interval = float(metrics_interval)
        self.fidelity_every = int(fidelity_every)
        self.windows: List[Dict[str, Any]] = []
        self._jsonl = (MetricsJsonlWriter(metrics_path)
                       if metrics_path else None)
        self._last_flush = time.perf_counter()
        self._queued_ts: Dict[int, float] = {}     # rid -> submit time
        self._last_tok: Dict[int, float] = {}      # rid -> last delivery
        self._active: Set[int] = set()             # rids with open span
        # the scheduler reports request_finished (inside collect) before
        # the front-end fans the final chunk's tokens out, so the timing
        # state moves here at finish and the trailing tokens_delivered
        # consumes it — a one-chunk request still gets its TTFT
        self._finished_ts: Dict[int, tuple] = {}

    # -- request lifecycle ---------------------------------------------

    def request_queued(self, rid: int, prompt_len: int,
                       priority: int) -> None:
        now = time.perf_counter()
        self._queued_ts[rid] = now
        self.registry.counter("serve.requests_submitted").inc()
        tr = self.tracer
        if tr is not None and tr.sampled(rid):
            tr.begin_async("request", rid, f"req{rid}",
                           {"prompt_len": int(prompt_len),
                            "priority": int(priority)})

    def request_admitted(self, rid: int, slot: int,
                         prefix_hit: bool) -> None:
        now = time.perf_counter()
        t0 = self._queued_ts.get(rid)
        if t0 is not None:
            self.registry.hist("serve.queue_wait_s").observe(now - t0)
        self.registry.counter("serve.requests_admitted").inc()
        self._active.add(rid)
        tr = self.tracer
        if tr is not None and tr.sampled(rid):
            tr.begin_async("request", rid, "active",
                           {"slot": int(slot),
                            "prefix_hit": bool(prefix_hit)})

    def admission_deferred(self, rid: int) -> None:
        """Head-of-queue request could not be admitted (pool pressure /
        copy-on-write headroom): counted so stalls are visible in
        windows."""
        self.registry.counter("serve.admission_deferred").inc()

    def request_preempted(self, rid: int, slot: int,
                          n_emitted: int) -> None:
        self.registry.counter("serve.preemptions").inc()
        tr = self.tracer
        if rid in self._active:
            self._active.discard(rid)
            if tr is not None and tr.sampled(rid):
                tr.end_async("request", rid, "active",
                             {"preempted": True,
                              "emitted": int(n_emitted)})
        if tr is not None and tr.sampled(rid):
            tr.instant("preempt", {"rid": int(rid), "slot": int(slot)})

    def request_finished(self, rid: int, status: str,
                         n_tokens: int) -> None:
        self.registry.counter(f"serve.completions.{status}").inc()
        tr = self.tracer
        sampled = tr is not None and tr.sampled(rid)
        if rid in self._active:
            self._active.discard(rid)
            if sampled:
                tr.end_async("request", rid, "active")
        if sampled:
            tr.end_async("request", rid, f"req{rid}",
                         {"status": status, "tokens": int(n_tokens)})
        t0 = self._queued_ts.pop(rid, None)
        lt = self._last_tok.pop(rid, None)
        if t0 is not None or lt is not None:
            self._finished_ts[rid] = (t0, lt)
            if len(self._finished_ts) > 1024:
                # a finished request's final delivery lands within one
                # pump iteration; older entries were never claimed
                # (closed-batch callers with no stream fan-out), so
                # dropping the oldest half is safe bounded cleanup
                for k in list(self._finished_ts)[:512]:
                    self._finished_ts.pop(k, None)

    # -- token delivery (front-end) ------------------------------------

    def tokens_delivered(self, rid: int, n_new: int) -> None:
        """``n_new`` tokens just fanned out to a stream handle.  First
        delivery records TTFT (submit -> first token); later deliveries
        record the per-delivery gap as inter-token latency (tokens
        inside one delivered chunk land together, so the gap is the
        perceived ITL at chunk granularity)."""
        if n_new <= 0:
            return
        now = time.perf_counter()
        t0 = self._queued_ts.get(rid)
        last = self._last_tok.get(rid)
        finished = t0 is None and last is None
        if finished:
            t0, last = self._finished_ts.pop(rid, (None, None))
        if last is not None:
            self.registry.hist("serve.itl_s").observe(now - last)
        elif t0 is not None:
            self.registry.hist("serve.ttft_s").observe(now - t0)
        if not finished:
            self._last_tok[rid] = now
        self.registry.counter("serve.tokens_delivered").inc(n_new)

    def backpressure_wait(self, dur_s: float) -> None:
        self.registry.counter("serve.backpressure_stalls").inc()
        self.registry.hist("serve.backpressure_wait_s").observe(dur_s)

    # -- pump phases / engine events -----------------------------------

    def pump_span(self, name: str, t0_s: float, dur_s: float,
                  args: Optional[dict] = None) -> None:
        """One host-side pump phase ("dispatch" host time, "collect"
        block time) as an "X" span; also feeds the phase histogram."""
        self.registry.hist(f"pump.{name}_s").observe(dur_s)
        if self.tracer is not None:
            self.tracer.complete(name, t0_s * 1e6, dur_s * 1e6, args)

    def prefill_span(self, slot: int, off: int, rows: int,
                     dur_s: float) -> None:
        """Host time of staging and launching one chunked-prefill step
        (the device work is asynchronous; this is the pump-side
        cost)."""
        self.registry.counter("serve.prefill_chunks").inc()
        if self.tracer is not None:
            t1 = time.perf_counter()
            self.tracer.complete("prefill_chunk", (t1 - dur_s) * 1e6,
                                 dur_s * 1e6,
                                 {"slot": int(slot), "off": int(off),
                                  "rows": int(rows)})

    def fold(self, slot: int, rows: int) -> None:
        """``rows`` KV rows folded from a slot's exact window into its
        count-sketch tail (their pool blocks freed)."""
        self.registry.counter("serve.fold_events").inc()
        self.registry.counter("serve.fold_rows").inc(rows)
        if self.tracer is not None:
            self.tracer.instant("fold", {"slot": int(slot),
                                         "rows": int(rows)})

    def spec_round(self, rid: int, proposed: int,
                   accepted: int) -> None:
        self.registry.counter("spec.rounds").inc()
        self.registry.counter("spec.proposed").inc(proposed)
        self.registry.counter("spec.accepted").inc(accepted)
        tr = self.tracer
        if tr is not None and tr.sampled(rid):
            tr.instant("spec_round", {"rid": int(rid),
                                      "proposed": int(proposed),
                                      "accepted": int(accepted)})

    def prefix_event(self, kind: str) -> None:
        """Prefix-cache outcome: hit / miss / admit / evict / defer."""
        self.registry.counter(f"prefix.{kind}").inc()

    def chunk_collected(self, tokens: int, queue_depth: int,
                        active_slots: int) -> None:
        """End of one decode round (the per-round sync point)."""
        self.registry.counter("serve.tokens_committed").inc(tokens)
        self.registry.counter("serve.decode_rounds").inc()
        self.registry.gauge("serve.queue_depth").set(queue_depth)
        self.registry.gauge("serve.active_slots").set(active_slots)
        if self.tracer is not None:
            self.tracer.counter("engine",
                                {"queue_depth": int(queue_depth),
                                 "active_slots": int(active_slots)})

    def fidelity(self, slot: int, rid: int, fold_rows: int,
                 spread: float) -> None:
        """Sketch-fidelity probe sample: relative spread of the per-
        hash-row tail estimates for one folded slot (0 = rows agree
        perfectly; grows with collision variance)."""
        self.registry.gauge(f"kv.tail_spread.slot{slot}").set(spread)
        self.registry.hist("kv.tail_spread").observe(spread)
        tr = self.tracer
        if tr is not None:
            tr.counter(f"tail_spread/slot{slot}",
                       {"spread": float(spread)})
            if tr.sampled(rid):
                tr.instant("tail_fidelity",
                           {"rid": int(rid), "slot": int(slot),
                            "fold_rows": int(fold_rows),
                            "spread": float(spread)})

    # -- windowing / export --------------------------------------------

    def maybe_flush(self, stats: Union[Callable[[], Any], Any,
                                       None] = None) -> None:
        """Flush a metrics window if ``metrics_interval`` has elapsed
        (<= 0: every call).  Cheap no-op otherwise."""
        if time.perf_counter() - self._last_flush \
                < self.metrics_interval:
            return
        self.flush(stats)

    def flush(self, stats: Union[Callable[[], Any], Any,
                                 None] = None) -> Dict[str, Any]:
        """Force one metrics window: mirror ``stats`` (an EngineStats
        or a callable producing one) into the registry, snapshot,
        retain, and write to the JSONL sink if configured."""
        if stats is not None:
            st = stats() if callable(stats) else stats
            self.registry.update_from_stats(st)
        w = self.registry.window()
        self.windows.append(w)
        if len(self.windows) > _MAX_WINDOWS:
            del self.windows[:-_MAX_WINDOWS]
        if self._jsonl is not None:
            self._jsonl.write(w)
        self._last_flush = time.perf_counter()
        return w

    def close(self, stats: Union[Callable[[], Any], Any, None] = None,
              trace_path: Optional[str] = None) -> None:
        """Final flush + close sinks; writes the trace file if a path
        is given and tracing was on."""
        self.flush(stats)
        if self._jsonl is not None:
            self._jsonl.close()
        if trace_path and self.tracer is not None:
            write_trace(self.tracer, trace_path)
