"""Where the host's time goes in a graphed serve stream on the card.

    python3 tools/host_profile.py [--phase serve|long]

Builds the kernels and full-width gemma-2b (random weights) as
``chip_smoke.py`` does and serves the phase's stream (``serve``: the
16-request stream at max_seq 512; ``long``: the sketched 8k stream)
three times through one graphed engine with a full observer
(``repro_torch.obs``): pass 1 makes the captures; pass 2 is split by its
trace events (``chip_smoke.host_split``: the pump's dispatch and collect
spans, the prefill chunks' host launch spans, the rest of the wall);
pass 3 runs with host timers around the scheduler's, the prefix cache's
and the front end's steps and prints, per step, its calls and the
seconds spent inside it (inclusive: a step's time holds the steps it
calls).  The timers add a few microseconds a call.  First it times one
scalar write into a device tensor issued behind a ~50 ms kernel, into a
0-dim view (``t[0] = 1``, as admission writes a slot's position) and
into a one-element slice (``t[0:1] = 1``): PyTorch copies a Python
scalar into a 0-dim view as a blocking host-to-device copy, which waits
for the stream to drain, and fills a slice with a kernel.  Needs one
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HOME)
sys.path.insert(0, os.path.join(HOME, "src"))

import chip_smoke as cs  # noqa: E402

# (owner, attribute) of the host steps pass 3 times: owner "sched" is the
# engine's scheduler, "cache" its prefix cache, "front" the front end,
# "kvs" the serve/kv_sketch module
STEPS = (
    ("front", "_deliver_progress"), ("sched", "expire_deadlines"),
    ("sched", "admit_pending"), ("sched", "_admit"),
    ("cache", "lookup"), ("cache", "peek"), ("cache", "observe"),
    ("cache", "admit"), ("sched", "_chunk_prefill_loop"),
    ("sched", "_sketch_prefill_admit"), ("sched", "_prefill_one"),
    ("sched", "_ensure_exclusive"), ("kvs", "fold_pool"),
    ("sched", "dispatch"), ("sched", "_plan_folds"),
    ("sched", "_finish_folds"), ("sched", "collect"), ("sched", "_retire"),
    ("sched", "progress"),
)


def timed(owner, name, book):
    """Wrap ``owner.name`` so that every call adds its seconds to
    ``book[name]`` = [seconds, calls]."""
    fn = getattr(owner, name)

    def call(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            b = book.setdefault(name, [0.0, 0])
            b[0] += time.perf_counter() - t0
            b[1] += 1

    setattr(owner, name, call)


def scalar_write_ms(dev):
    """Host ms of ``t[0] = 1`` and of ``t[0:1] = 1`` on a device tensor,
    each issued behind a sleep kernel, and that kernel's device ms."""
    import torch
    t = torch.zeros((8,), dtype=torch.int32, device=dev)
    out = {}
    for name, index in (("0-dim view", 0), ("slice", slice(0, 1))):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        torch.cuda._sleep(100_000_000)
        ev[1].record()
        t0 = time.perf_counter()
        t[index] = 1
        out[name] = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        out[f"sleep before the {name}"] = ev[0].elapsed_time(ev[1])
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("serve", "long"), default="long")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.serve import kv_sketch as kvs
    from repro_torch.serve.frontend import AsyncServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    scalar_write_ms(dev)                    # warm
    print("[host] host ms of one scalar write behind a queued kernel: "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      scalar_write_ms(dev).items()) + f"; {cs.card()}")
    cfg = get_config("gemma-2b")
    params = tf.init_params(cfg, seed=cs.SEED, device=dev)
    serve, reqs = (cs.serve_stream if args.phase == "serve"
                   else cs.long_stream)(cfg)
    obs = cs.full_observer({})
    front = AsyncServeEngine(cfg, params, serve=serve, device=dev, obs=obs)
    run = lambda: cs.drive_stream(front, cs.with_generators(reqs, dev),
                                  False)
    run()                                   # pass 1: the captures
    n0 = len(obs.tracer)
    done, _, wall, _ = run()
    ntok = sum(len(c.tokens) for c in done)
    print(f"[host] {args.phase} pass 2 (captured): "
          f"{cs.host_split(obs.tracer.events()[n0:], wall)}; {ntok} tokens "
          f"= {ntok / wall:.2f} tok/s; {cs.card()}")
    owners = dict(sched=front.scheduler, cache=front.scheduler.prefix_cache,
                  front=front, kvs=kvs)
    book = {}
    for owner, name in STEPS:
        timed(owners[owner], name, book)
    n0 = len(obs.tracer)
    done, _, wall, _ = run()
    print(f"[host] {args.phase} pass 3, host timers: "
          f"{cs.host_split(obs.tracer.events()[n0:], wall)}; inside each "
          f"step (inclusive s, calls): "
          + ", ".join(f"{name} {book[name][0]:.4f} ({book[name][1]})"
                      for _, name in STEPS if name in book)
          + f"; {cs.card()}")


if __name__ == "__main__":
    main()
