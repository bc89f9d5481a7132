"""Windowed serve metrics: counters, gauges, log-bucket histograms (the
port's copy of ``repro/obs/metrics.py``; plain Python, no torch).

``EngineStats`` is a cumulative snapshot; operating a serving engine
needs rates over an interval — tok/s right now, TTFT p99 over the last
half second, fold rows per second — not lifetime totals.  This module
layers a small registry on top:

  * ``Counter``  — monotonic totals.  Fed either incrementally
    (``inc``) by observer hooks or absolutely (``set_total``) from the
    cumulative ``EngineStats`` fields, so windowed deltas of an
    engine counter always sum back to the engine's final snapshot.
  * ``Gauge``    — last-value instruments (queue depth, active slots,
    per-slot tail-fidelity spread).
  * ``Histogram``— geometric (log-spaced) buckets with interpolated
    quantiles; fixed memory regardless of sample count, and windowed
    quantiles computed over per-interval bucket deltas.

``MetricsRegistry.window()`` produces one self-contained snapshot dict:
interval deltas and rates for every counter, current gauge values, and
delta-count/sum/p50/p90/p99 for every histogram.  Snapshots are plain
JSON-able dicts — the JSONL exporter writes them verbatim.

``update_from_stats`` maps an ``EngineStats`` dataclass into the
registry using the per-field ``kind`` metadata tags (counter / gauge /
peak / geometry) that ``EngineStats.merge`` also uses, so the merge
semantics and the metrics semantics can never drift apart.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional


class Counter:
    """Monotonic counter.  ``inc`` for event-driven totals,
    ``set_total`` to mirror an externally-cumulated value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set_total(self, v: float) -> None:
        self.value = float(v)


class Gauge:
    """Last-value instrument."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log-bucket histogram: bucket ``i`` counts samples in
    ``(lo * growth**i, lo * growth**(i+1)]`` plus one overflow bucket,
    so relative quantile error is bounded by ``growth`` at constant
    memory.  Defaults cover 1 microsecond .. ~3 hours of latency."""

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 growth: float = 1.3):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError(f"Histogram needs 0 < lo < hi and growth > 1, "
                             f"got lo={lo} hi={hi} growth={growth}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.growth = float(growth)
        n = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        # bounds[i] is bucket i's inclusive upper edge
        self.bounds = [lo * growth ** (i + 1) for i in range(n)]
        self.counts = [0] * (n + 1)            # + overflow bucket
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, x: float) -> None:
        x = float(x)
        i = bisect.bisect_left(self.bounds, x)
        self.counts[min(i, len(self.counts) - 1)] += 1
        self.count += 1
        self.sum += x
        if x > self.max:
            self.max = x

    def _edges(self, i: int) -> tuple:
        lo = self.lo * self.growth ** i
        if i < len(self.bounds):
            return lo, self.bounds[i]
        return lo, max(self.max, lo * self.growth)   # overflow bucket

    def quantile(self, q: float, counts: Optional[List[int]] = None,
                 total: Optional[int] = None) -> float:
        """Geometrically interpolated q-quantile over ``counts``
        (default: the cumulative counts)."""
        counts = self.counts if counts is None else counts
        total = sum(counts) if total is None else total
        if total <= 0:
            return 0.0
        target = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if c and cum >= target:
                lo, hi = self._edges(i)
                frac = (target - (cum - c)) / c
                return lo * (hi / lo) ** max(frac, 0.0)
        lo, hi = self._edges(len(counts) - 1)
        return hi


class MetricsRegistry:
    """Named counters / gauges / histograms plus windowing state (the
    previous snapshot each ``window()`` call diffs against)."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.hists: Dict[str, Histogram] = {}
        self._seq = 0
        self._last = time.perf_counter()
        self._prev_counter: Dict[str, float] = {}
        self._prev_hist: Dict[str, tuple] = {}

    # -- instrument lookup (get-or-create) -----------------------------

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def hist(self, name: str, **kw: Any) -> Histogram:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Histogram(**kw)
        return h

    # -- EngineStats bridge --------------------------------------------

    def update_from_stats(self, stats: Any,
                          prefix: str = "engine.") -> None:
        """Mirror a kind-tagged stats dataclass (``EngineStats``) into
        the registry: ``counter`` fields become monotonic counters
        (windowed deltas therefore sum back to the cumulative
        snapshot), ``gauge``/``peak``/``geometry`` fields become
        gauges."""
        for f in dataclasses.fields(stats):
            v = getattr(stats, f.name)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            kind = f.metadata.get("kind", "counter")
            if kind == "counter":
                self.counter(prefix + f.name).set_total(v)
            else:
                self.gauge(prefix + f.name).set(v)

    # -- windowing -----------------------------------------------------

    def window(self) -> Dict[str, Any]:
        """One windowed snapshot: per-counter {total, delta, rate},
        current gauges, per-histogram interval stats.  Diffing state
        advances, so consecutive windows tile the timeline and their
        counter deltas sum to the final totals."""
        now = time.perf_counter()
        dur = max(now - self._last, 1e-9)
        self._last = now
        self._seq += 1

        counters: Dict[str, Any] = {}
        for n, c in self.counters.items():
            prev = self._prev_counter.get(n, 0.0)
            d = c.value - prev
            self._prev_counter[n] = c.value
            counters[n] = {"total": c.value, "delta": d, "rate": d / dur}

        hists: Dict[str, Any] = {}
        for n, h in self.hists.items():
            pc, pn, ps = self._prev_hist.get(
                n, ([0] * len(h.counts), 0, 0.0))
            if len(pc) != len(h.counts):
                pc = [0] * len(h.counts)
            dc = [a - b for a, b in zip(h.counts, pc)]
            dn = h.count - pn
            self._prev_hist[n] = (list(h.counts), h.count, h.sum)
            hists[n] = {
                "count": dn, "sum": h.sum - ps,
                "p50": h.quantile(0.50, dc, dn),
                "p90": h.quantile(0.90, dc, dn),
                "p99": h.quantile(0.99, dc, dn),
                "max": h.max,
            }

        return {"ts": time.time(), "seq": self._seq, "dur_s": dur,
                "counters": counters,
                "gauges": {n: g.value for n, g in self.gauges.items()},
                "hists": hists}
