"""Exporters for the serve observability layer (the port's copy of
``repro/obs/export.py``).

Three sinks, all dependency-free:

  * ``write_trace``     — Chrome trace-event JSON (``{"traceEvents":
    [...]}``) from a ``Tracer``; open the file in Perfetto
    (https://ui.perfetto.dev) or ``chrome://tracing``.
  * ``MetricsJsonlWriter`` — one ``MetricsRegistry.window()`` snapshot
    per line, flushed per write so a crashed or killed server still
    leaves a parseable stream.
  * ``prometheus_text`` — Prometheus text exposition (v0.0.4) of the
    registry's current state, for scrape endpoints or debugging dumps.
"""
from __future__ import annotations

import json
import re
from typing import IO, Any, Dict, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def write_trace(tracer: Tracer, path: str) -> int:
    """Write the tracer's events as Chrome trace-event JSON; returns
    the number of events written."""
    events = tracer.events()
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
    return len(events)


class MetricsJsonlWriter:
    """Append-only JSONL sink for windowed metric snapshots."""

    def __init__(self, path: str):
        self.path = path
        self.written = 0
        self._fh: Optional[IO[str]] = open(path, "w")

    def write(self, window: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        self._fh.write(json.dumps(window) + "\n")
        self._fh.flush()
        self.written += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def prometheus_text(reg: MetricsRegistry,
                    namespace: str = "repro") -> str:
    """Render the registry in Prometheus text exposition format.
    Histograms are exposed as summaries (cumulative ``_count`` /
    ``_sum`` plus quantile samples) since the log buckets are an
    internal representation."""
    lines = []
    for name, c in sorted(reg.counters.items()):
        m = f"{namespace}_{_sanitize(name)}"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {c.value:g}")
    for name, g in sorted(reg.gauges.items()):
        m = f"{namespace}_{_sanitize(name)}"
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {g.value:g}")
    for name, h in sorted(reg.hists.items()):
        m = f"{namespace}_{_sanitize(name)}"
        lines.append(f"# TYPE {m} summary")
        for q in (0.5, 0.9, 0.99):
            lines.append(
                f'{m}{{quantile="{q}"}} {h.quantile(q):g}')
        lines.append(f"{m}_sum {h.sum:g}")
        lines.append(f"{m}_count {h.count}")
    return "\n".join(lines) + "\n"
