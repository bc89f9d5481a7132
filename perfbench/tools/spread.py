"""Spreads of a cell's runs, the basis of its bounds.

    python3 perfbench/tools/spread.py RESULTS.jsonl [RESULTS2.jsonl ...]

Each file holds result lines (one JSON object a line, as ``run.py``
prints them), each file one set of runs.  For each metric and set it
prints the median and the spread: the distance between the first and the
third quartile (``statistics.quantiles(values, n=4)``) over the median;
then the wider spread of the sets, five times it (never under 1%), and
how far the second set's median lies from the first's.
"""
import json
import statistics
import sys


def load(path):
    out = []
    for line in open(path):
        line = line.strip()
        if line.startswith("{"):
            out.append(json.loads(line))
    return out


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths):
    sets = [load(p) for p in paths]
    names = sorted({m for s in sets for line in s for m in line["metrics"]})
    for name in names:
        vals = [[line["metrics"][name]["value"] for line in s
                 if name in line["metrics"]] for s in sets]
        row = []
        for v in vals:
            if len(v) >= 2:
                row.append(f"median {statistics.median(v):.6g} spread "
                           f"{spread(v):.4%} (n={len(v)})")
        widest = max(spread(v) for v in vals if len(v) >= 2)
        meds = [statistics.median(v) for v in vals if v]
        shift = abs(meds[-1] - meds[0]) / meds[0] if len(meds) > 1 else 0.0
        print(f"{name}: " + "; ".join(row) + f"; widest {widest:.4%}, "
              f"5x {max(5 * widest, 0.01):.4%}, second median off by "
              f"{shift:.4%}")
    for s, p in zip(sets, paths):
        bad = [line["checks"] for line in s if not line["correct"]]
        print(f"{p}: {len(s)} runs, {len(bad)} not correct")


if __name__ == "__main__":
    main(sys.argv[1:])
