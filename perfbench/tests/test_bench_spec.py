"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""
import json
import re

import pytest

from perfbench import common

SPEC = common.bench_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_text():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in SPEC[k]]
        assert len(got) == len(set(got))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for x in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


def test_every_config_used_and_found():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        conf = common.load_json(common.ROOT / c["file"])
        assert conf["name"] == c["name"]
        assert c["file"].startswith("perfbench/")


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_by_name(w):
    conf = common.load_config(SPEC, w["config"])
    mix = common.load_mix(w["traffic"])
    assert common.driver(mix["kind"]).run
    limits = common.load_limits(w["name"])
    assert limits and all(v >= 0 for v in limits.values())
    assert w["chips"] == 1
    e2e = {m["name"] for m in common.end_to_end_metrics(SPEC, w["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = common.per_layer_metrics(SPEC, w["name"])
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(common.metric_reader(m["name"]).read)
    assert conf["num_hidden_layers"] > 0


def test_per_layer_metrics_move_a_declared_metric():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)
