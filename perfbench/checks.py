"""The numbers that decide ``correct``, each against a limit of the
cell's ``limits/<workload>.json``.

Training: ``grad_gap``, the worst leaf's gap between the program's and
the reference's first-step gradient norm; ``moment_gap``, over the
sketched leaves and their two moment tables after the first step, the
worst gap between the program's and the reference's projections of the
table on seeded random directions (``perfbench/project.py``: first order
in every entry, so it sees a wrong hash or a coarser gradient where a
norm does not); ``delta_gap``, the median leaf's gap between their
changes ``||p - p0||`` after the checked step (the worst leaf's swings
with a few coordinates whose second-moment estimate is 0, PERF.md).
Each checked step's relative loss gap is read and reported
(``train_gaps``) but not compared: neither the control nor a fault
separates it from sound runs (PERF.md).  A leaf's gap is measured
against the reference's norm of that leaf (or table) or of the median
leaf's, whichever is larger.  A leaf whose reference gradient is under a
thousandth of the median leaf's is left out of ``delta_gap`` (it moves
by round-off alone).

Serving, over every checked request (each completed greedy request, up
to the mix's ``check.requests``): ``request_logit_gap``, the median of a
request's mean gap by which its served tokens' logits lie below the
reference's best at their positions (the float8 control moves it);
``widest_logit_gap``, the widest such gap at any checked token (a token
altered where it is produced, in any one request or slot, moves it);
``short_answers``, requests completed with another number of tokens than
they asked for (exact: limit 0).
"""
from __future__ import annotations

import statistics
from typing import Dict


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              counted=None) -> Dict[str, float]:
    """Each counted leaf's gap, against the larger of its reference norm
    and the median leaf's."""
    keys = [k for k in ref if counted is None or k in counted]
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def moment_gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """Per sketched leaf and table ("<leaf>:m", "<leaf>:v"): the root mean
    square over the directions of the projections' gap, against the
    larger of the reference table's norm and the median leaf's."""
    out = {}
    for kind in ("m", "v"):
        norms = [ref[k][kind]["norm"] for k in ref]
        med = statistics.median(norms) if norms else 0.0
        for k, r in ref.items():
            g = got.get(k)
            if g is None or len(g[kind]["proj"]) != len(r[kind]["proj"]):
                out[f"{k}:{kind}"] = float("inf")
                continue
            sq = [(a - b) ** 2 for a, b in zip(g[kind]["proj"],
                                                r[kind]["proj"])]
            out[f"{k}:{kind}"] = (sum(sq) / len(sq)) ** 0.5 / max(
                r[kind]["norm"], med, 1e-30)
        for k in got:
            if k not in ref:            # sketched here, dense there
                out[f"{k}:{kind}"] = float("inf")
    return out


def train_gaps(got: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """Every gap: per step (losses), per leaf (gradients, changes) and
    per sketched table (moments)."""
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    counted = {k for k, v in g.items() if v >= 1e-3 * med}
    return {"loss": {str(i): abs(a - b) / abs(b) for i, (a, b) in
                     enumerate(zip(got["losses"], ref["losses"]))},
            "grad": leaf_gaps(got["grad_norms"], g),
            "moment": moment_gaps(got["moments"], ref["moments"]),
            "delta": leaf_gaps(got["deltas"], ref["deltas"], counted)}


def train_numbers(got: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers: the worst leaf's gradient gap, the worst
    sketched table's projection gap, the median leaf's change gap."""
    gaps = train_gaps(got, ref)
    return {"grad_gap": max(gaps["grad"].values()),
            "moment_gap": max(gaps["moment"].values(), default=0.0),
            "delta_gap": statistics.median(gaps["delta"].values())}
