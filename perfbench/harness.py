"""One run of one cell: the driver named by the cell's traffic mix runs
the program, the cell's metrics are read, the outputs are judged against
the reference, and the result line is built.

``run_cell`` is everything a run does after the look for a card, so the
checks' tests can drive it on the CPU at small sizes."""
from __future__ import annotations

import json
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from perfbench import common

BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Context:
    workload: str
    conf: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_process: float             # perf_counter at process start
    log: Callable[[str], None] = print
    readings: bool = False       # also read the control and the faults


@dataclass
class Outcome:
    e2e: Dict[str, float]                   # end-to-end metric values
    obs: Dict[str, Any]                     # what the metric readers read
    checks: List[Tuple[str, float, float]]  # (name, value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    profile: Any = None                     # devtrace.Summary or None
    notes: Dict[str, Any] = field(default_factory=dict)


def banned_modules(modules) -> List[str]:
    """Top-level names among ``modules`` that the run may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".")[0] for m in modules}
    return sorted(tops & set(BANNED_MODULES))


def card_info() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        name, limit = (s.strip() for s in out[0].split(","))
        return {"name": name, "power_limit": limit}
    except Exception as e:           # reported, never fatal
        return {"name": "unknown", "power_limit": f"unread ({e})"}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_process: Optional[float] = None,
             conf: Optional[Dict] = None, mix: Optional[Dict] = None,
             limits: Optional[Dict] = None,
             log: Callable[[str], None] = print,
             readings: bool = False) -> Dict[str, Any]:
    """Run the cell once and return its result line (a dict, ``checks``
    last).  ``conf``, ``mix`` and ``limits`` replace the cell's files
    (the tests' small sizes); ``readings`` (``tools/control.py``, never a
    benchmark run) adds the control's and the faults' readings under
    ``notes``."""
    import torch
    spec = common.bench_spec()
    w = common.workload(spec, workload)
    ctx = Context(
        workload=workload,
        conf=conf or common.load_config(spec, w["config"]),
        mix=mix or common.load_mix(w["traffic"]),
        limits=limits or common.load_limits(workload),
        seed=int(seed), seconds=float(seconds), trace=bool(trace),
        device=torch.device(device),
        t_process=time.perf_counter() if t_process is None else t_process,
        log=log, readings=readings)
    out: Outcome = common.driver(ctx.mix["kind"]).run(ctx)
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        for m in common.per_layer_metrics(spec, workload):
            v = common.metric_reader(m["name"]).read(out.obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in common.end_to_end_metrics(spec, workload):
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]),
                                  "unit": m["unit"]}
    cuda = ctx.device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(out.memory_peak_bytes)}
    line: Dict[str, Any] = {
        "correct": all(v <= lim for _, v, lim in out.checks),
        "attempted": int(out.attempted), "failed": int(out.failed),
        "metrics": metrics, "device": dev}
    if trace and out.profile is not None:
        dev["busy_s"] = out.profile.busy_s
        dev["window_s"] = out.profile.window_s
        line["breakdown"] = out.profile.breakdown()
    if cuda:
        card = card_info()
        log(f"[card] {card['name']}, power limit {card['power_limit']}")
    log(f"[notes] {json.dumps(out.notes)}")
    if readings:
        line["notes"] = out.notes
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in out.checks}
    return line
