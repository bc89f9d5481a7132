"""Paths, seeds and the files of the benchmark, found by name.

Everything a cell needs is looked up from its entry in ``BENCHMARK.json``:
its configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names the driver in
``drivers/``), its limits (``limits/<workload>.json``) and one reader per
per-layer metric (``metrics/<metric>.py``).  Nothing here imports torch.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent          # perfbench/
ROOT = HERE.parent                              # the checkout


def sub_seed(seed: int, *tags: Any) -> int:
    """A 63-bit seed derived from the run's ``--seed`` and ``tags``: the
    same arguments give the same seed on every machine."""
    text = ":".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") & ((1 << 63) - 1)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def bench_spec(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def workload(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(spec: Dict[str, Any], name: str) -> Path:
    for c in spec["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    return load_json(config_file(spec, name))


def load_mix(name: str) -> Dict[str, Any]:
    return load_json(HERE / "traffic" / f"{name}.json")


def load_limits(workload_name: str) -> Dict[str, float]:
    return load_json(HERE / "limits" / f"{workload_name}.json")["limits"]


def _cell_listed(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_metrics(spec: Dict[str, Any], cell: str
                       ) -> List[Dict[str, Any]]:
    return [m for m in spec["end_to_end"] if _cell_listed(m, cell)]


def per_layer_metrics(spec: Dict[str, Any], cell: str
                      ) -> List[Dict[str, Any]]:
    """The per-layer metrics a cell reports: those listed for it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(spec, cell)}
    return [m for m in spec["per_layer"]
            if m["moves"] in e2e and _cell_listed(m, cell)]


def load_module(path: Path) -> ModuleType:
    """A harness file by path (metric readers have dots in their names)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py")


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"perfbench.drivers.{kind}")
