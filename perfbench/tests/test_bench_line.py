"""A run's result line, driven on the CPU at small sizes (the look for a
card skipped)."""
import json
import math

import pytest
import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("make", [tiny.train_cell, tiny.serve_cell],
                         ids=["train", "serve"])
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_result_line(make, trace):
    cell = make()
    line = tiny.run(cell, trace=trace)
    json.dumps(line)
    keys = list(line)
    assert keys[-1] == "checks"
    assert set(keys) - {"breakdown"} == set(KEYS + ["checks"])
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert dev["count"] == 1 and dev["platform"] == "cpu"
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["unit"]
    if not trace:
        assert "setup_s" in line["metrics"]
        assert "peak_mem_gib" in line["metrics"]
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_run_refuses_without_a_card(tmp_path):
    import subprocess
    import sys

    from perfbench import common
    r = subprocess.run(
        [sys.executable, str(common.HERE / "run.py"), "--workload",
         "yi-9b.train-4k-sketched", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        cwd=common.ROOT, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
