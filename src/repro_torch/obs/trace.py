"""Sampled low-overhead request/phase tracer for the serve path (the
port's copy of ``repro/obs/trace.py``).

Records the full request lifecycle — queued -> admitted -> prefill
chunks -> decode chunks -> fold events -> speculative rounds ->
completion / cancel / expire / preempt — as Chrome trace-event JSON
(the ``traceEvents`` array format), loadable directly in Perfetto or
``chrome://tracing``.

Design constraints (the whole point of this module):

  * host-only: every hook takes values the pump already holds on the
    host (mirrors, counters, wall-clock durations).  Nothing here ever
    touches a device tensor, so tracing adds no device sync to the hot
    path — the one wait per round stays ``collect()``.  A span around a
    launch is the host's cost of the launch (on the card, of a graph
    replay), never the device's time.
  * monotonic clock: timestamps are ``time.perf_counter()`` in
    microseconds (the trace-event unit), immune to wall-clock steps.
  * sampled: per-request lifecycle events are gated by a deterministic
    hash of the rid against ``sample_rate``, so heavy traffic can trace
    a stable subset; per-chunk pump spans are bounded (one per phase
    per round) and always recorded.
  * bounded: at most ``max_events`` events are retained; overflow is
    counted in ``dropped`` and surfaced as trace metadata, never an
    allocation blow-up.

Event vocabulary (Chrome trace-event phases):

  "b"/"e"  async nestable spans keyed by (cat, id) — one outer
           ``req<rid>`` span per request (queued -> resolved) with a
           nested ``active`` span per residency (admission -> retire /
           preempt; a preempted request opens a fresh ``active`` span
           when it is re-admitted);
  "X"      complete spans for pump phases (dispatch host time, collect
           block time, per-chunk prefill dispatch) on tid 1;
  "i"      instants for point events (folds, preemptions, expiries);
  "C"      counter tracks (queue depth / active slots per round).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

# pid/tid layout: one fake process; tid 0 carries request spans and
# counters, tid 1 carries pump-phase spans, so Perfetto renders the
# request timeline and the engine phases as two parallel tracks
_PID = 1
_TID_REQ = 0
_TID_PUMP = 1

# Knuth multiplicative hash: deterministic rid -> [0, 1) sampling that
# needs no RNG state and never re-decides for the same request
_HASH_MULT = 2654435761


class Tracer:
    """Append-only trace-event recorder.  All methods are cheap dict
    appends; formatting costs are paid once at export."""

    def __init__(self, sample_rate: float = 1.0,
                 max_events: int = 200_000):
        self.sample_rate = float(sample_rate)
        self.max_events = int(max_events)
        self.dropped = 0
        self._events: List[Dict[str, Any]] = []

    # -- clock / sampling ----------------------------------------------

    @staticmethod
    def now() -> float:
        """Monotonic timestamp in trace-event microseconds."""
        return time.perf_counter() * 1e6

    def sampled(self, rid: int) -> bool:
        """Deterministic per-request sampling decision: the same rid
        always resolves the same way, so a request's span can never be
        half-recorded."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        h = (int(rid) * _HASH_MULT) & 0xFFFFFFFF
        return h / 4294967296.0 < self.sample_rate

    # -- event emission ------------------------------------------------

    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        self._events.append(ev)

    def begin_async(self, cat: str, id_: int, name: str,
                    args: Optional[dict] = None,
                    ts: Optional[float] = None) -> None:
        self._push({"ph": "b", "cat": cat, "id": int(id_), "name": name,
                    "pid": _PID, "tid": _TID_REQ,
                    "ts": self.now() if ts is None else ts,
                    "args": args or {}})

    def end_async(self, cat: str, id_: int, name: str,
                  args: Optional[dict] = None,
                  ts: Optional[float] = None) -> None:
        self._push({"ph": "e", "cat": cat, "id": int(id_), "name": name,
                    "pid": _PID, "tid": _TID_REQ,
                    "ts": self.now() if ts is None else ts,
                    "args": args or {}})

    def instant(self, name: str, args: Optional[dict] = None,
                ts: Optional[float] = None, tid: int = _TID_REQ) -> None:
        self._push({"ph": "i", "name": name, "pid": _PID, "tid": tid,
                    "ts": self.now() if ts is None else ts, "s": "t",
                    "args": args or {}})

    def complete(self, name: str, ts_us: float, dur_us: float,
                 args: Optional[dict] = None,
                 tid: int = _TID_PUMP) -> None:
        """One "X" complete span: ``ts_us`` start, ``dur_us`` duration,
        both in trace microseconds (use ``Tracer.now()``)."""
        self._push({"ph": "X", "name": name, "pid": _PID, "tid": tid,
                    "ts": ts_us, "dur": max(dur_us, 0.0),
                    "args": args or {}})

    def counter(self, name: str, values: Dict[str, float],
                ts: Optional[float] = None) -> None:
        """One "C" counter sample; ``values`` become stacked series."""
        self._push({"ph": "C", "name": name, "pid": _PID, "tid": _TID_REQ,
                    "ts": self.now() if ts is None else ts,
                    "args": dict(values)})

    # -- export --------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> List[Dict[str, Any]]:
        """The recorded trace events (plus a metadata instant recording
        any overflow drops), ready for ``{"traceEvents": ...}``."""
        out = list(self._events)
        if self.dropped:
            out.append({"ph": "i", "name": "tracer_dropped_events",
                        "pid": _PID, "tid": _TID_REQ, "ts": self.now(),
                        "s": "g", "args": {"dropped": self.dropped}})
        return out
