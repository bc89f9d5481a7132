"""Readings that set the limits of ``correct``: sound runs, the control
(the reference in float8, put in the program's place) and the faults, on
the card at a cell's own size, over several seeds, in one process.  The
benchmark's own runs never run this.

    python3 perfbench/tools/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 1] [--what control,wrong_hash] [--out FILE]

Each seed runs the cell as a benchmark run does (``harness.run_cell``,
with a window of ``--seconds``) and keeps its checks.  ``control`` adds
the control's numbers, read in the same run against the same reference
(training: the float8 reference's first step; serving: the float8
reference's first choices and a token altered where it is produced, on
the run's checked requests).  Training faults, each a second run of the
program on the seed, judged against the first run's reference:
``wrong_hash`` gives every sketched table the seed of the next table
(the m table of leaf i takes v's seed), ``half_batch`` is the reference
with half of its batch left out.  One JSON line per seed, to standard
output and to ``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--what", default="control",
                    help="control; training also wrong_hash, half_batch")
    a = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import checks, common, harness
    from perfbench.reference import train as ref_train
    spec = common.bench_spec()
    w = common.workload(spec, a.workload)
    mix = common.load_mix(w["traffic"])
    conf = common.load_config(spec, w["config"])
    what = set(a.what.split(",")) - {""}
    log = lambda s: print(s, file=sys.stderr, flush=True)

    # one reference run a seed: a fault's run reuses the sound run's
    ref_run, cache = ref_train.run, {}

    def cached(*args, **kw):
        key = json.dumps([args[2:4], args[5:], kw], sort_keys=True)
        if key not in cache:
            if len(cache) > 4:
                cache.clear()
            cache[key] = ref_run(*args, **kw)
        return cache[key]
    ref_train.run = cached

    out = open(a.out, "a") if a.out else None
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        line = harness.run_cell(a.workload, seed, a.seconds, False,
                                readings="control" in what, log=log)
        row = {"seed": seed, "correct": line["correct"],
               "checks": line["checks"], "metrics": line["metrics"],
               **line["notes"]}
        if mix["kind"] == "train" and "wrong_hash" in what:
            from repro_torch.sketch import optimizer as sko
            leaf_seed = sko._leaf_seed
            sko._leaf_seed = lambda s, i: leaf_seed(s, i + 1)
            try:
                bad = harness.run_cell(a.workload, seed, a.seconds, False,
                                       log=log, readings=True)
            finally:
                sko._leaf_seed = leaf_seed
            row["wrong_hash"] = bad["checks"]
            row["wrong_hash_gaps"] = bad["notes"]["gaps"]["moment"]
        if mix["kind"] == "train" and "half_batch" in what:
            hs = common.sub_seed(seed, "hash") % (1 << 31)
            n = mix["check"]["steps"]
            dev = torch.device("cuda")
            ref = cached(conf, mix, seed, hs, dev, n)
            got = ref_run(conf, mix, seed, hs, dev, n, fault="half_batch")
            row["half_batch"] = checks.train_numbers(got, ref)
        row["seconds"] = time.perf_counter() - t
        text = json.dumps(row)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
