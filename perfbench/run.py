"""Run one cell of the benchmark once, on the card this machine holds.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as one JSON object, the last line of standard output,
and the numbers that decide ``correct``, each beside its limit, as the
last lines of standard error.  Exits non-zero without a result when the
machine lacks the cell's cards, when the port is not beside the harness
(``src/repro_torch``), or when the process has loaded JAX or the JAX
package.  Run from the root of a checkout."""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args()
    # caches stay in the checkout; nothing loads flax through a library
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no port beside the harness: {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import common, harness
    chips = common.workload(common.bench_spec(), a.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                            t_process=T_PROCESS,
                            log=lambda s: print(s, file=sys.stderr,
                                                flush=True))
    bad = harness.banned_modules(sys.modules)
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
