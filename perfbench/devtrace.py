"""Device time from the profiler's trace of a stretch of a run.

``Profile`` runs ``torch.profiler`` (CPU and CUDA activities) over a
stretch and reduces its raw records: the device records (kernels,
copies, sets) are merged into busy intervals, so ``busy_s`` is the time
in which any operation ran on the card; ``window_s`` is the stretch's
host wall time; ``by_name`` sums device seconds by record name; the idle
gaps between busy intervals are labelled with the innermost host record
open at each gap's middle.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def _span_ns(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        s, d = e.start_ns(), e.duration_ns()
    else:
        s, d = int(e.start_us() * 1000), int(e.duration_us() * 1000)
    return int(s), int(s + d)


NAME_CHARS = 160                 # a record's name as the breakdown gives it
LABELLED_GAPS = 4000             # longest gaps given a host record


def _open_at(host, starts, t: int, walk: int = 4000) -> str:
    """The latest-starting host record open at time t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - walk, -1), -1):
        if host[j][1] > t:
            return host[j][2]
    return "(no host record)"


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


class Summary:
    def __init__(self, window_s: float, device: List[Tuple[int, int, str]],
                 host: List[Tuple[int, int, str]]):
        self.window_s = window_s
        self.by_name: Dict[str, float] = defaultdict(float)
        for s, e, n in device:
            self.by_name[n] += (e - s) * 1e-9
        merged: List[List[int]] = []
        for s, e, _ in sorted(device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        gaps = defaultdict(float)
        if merged:
            lo = min([merged[0][0]] + [s for s, _, _ in host])
            hi = max([merged[-1][1]] + [e for _, e, _ in host])
            edges = [(lo, merged[0][0])] + [
                (merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)] + [(merged[-1][1], hi)]
            host_sorted = sorted(host)
            starts = [h[0] for h in host_sorted]
            edges = sorted((e for e in edges if e[1] > e[0]),
                           key=lambda e: e[0] - e[1])
            for k, (a, b) in enumerate(edges):
                if k >= LABELLED_GAPS:
                    gaps["(shorter gaps)"] += (b - a) * 1e-9
                    continue
                gaps[_open_at(host_sorted, starts, (a + b) // 2)] += \
                    (b - a) * 1e-9
        self.idle_by_host = dict(gaps)

    def seconds_matching(self, *parts: str) -> float:
        return sum(v for k, v in self.by_name.items()
                   if any(p in k for p in parts))

    def breakdown(self) -> Dict[str, list]:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:NAME_CHARS], v] for k, v in top],
                "idle_gaps": [[k[:NAME_CHARS], v] for k, v in gaps]}


class Profile:
    """``start()`` / ``stop()`` around a stretch; ``summary`` after stop.
    Disabled (``enabled=False``) it does nothing and ``summary`` stays
    None."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: Optional[Summary] = None
        self._prof = None

    def warm(self) -> None:
        """Start and stop once, so that a later start finds the tracer
        set up (its first start holds the host for seconds)."""
        if not self.enabled:
            return
        import torch
        self.start()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        self.stop()
        self.summary = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._prof is None:
            return
        t1 = time.perf_counter()
        self._prof.stop()
        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            s, t = _span_ns(e)
            (dev if _is_device(e) else host).append((s, t, e.name()))
        self.summary = Summary(t1 - self._t0, dev, host)
        self._prof = None
