"""Serving driver of the port: a mixed-length request stream through the
continuous-batching engine, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --full

The stream is the JAX driver's (``repro/launch/serve.py:
make_request_stream``, same numpy draws for one seed): a few shared
"system prompt" prefixes with random tails of mixed lengths, a
``--sampled-frac`` fraction decoded with seeded top-k sampling.  Requests
go through the async front-end: all at once, or as an open-loop Poisson
process with ``--arrival-rate``; ``--cancel-frac`` hangs up a fraction of
clients halfway through their budget.  Weights are random, from a seeded
``torch.Generator``; the reduced config is the default, ``--full`` serves
the published widths.  Without a card and without ``--device cpu`` the
driver raises.

Sketched long-context KV: ``--kv-sketch-window W`` keeps W exact rows per
slot and folds older blocks into FCS tail tables
(``--kv-sketch-ratio`` / ``--kv-sketch-rows`` size them);
``--long-context S`` appends one request with an S-token prompt, which
folds during its prefill.  E.g. on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --max-seq 512 --kv-sketch-window 64 --long-context 400

Speculative decoding: ``--spec-k K`` (any K) has a draft of the first
``--draft-depth`` layers propose K tokens a round, count-sketch-compressed
at ``--draft-sketch-ratio`` (with the FCS-sketched head) when it is > 0;
the exit summary then has a ``speculative:`` line.  Every attention
config speculates, the moe family (its experts compressed one by one)
and qwen2.5-32b's attention biases included.  E.g.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --spec-k 3 --draft-depth 1 --draft-sketch-ratio 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch granite-moe-3b-a800m --spec-k 4 --draft-sketch-ratio 4

The recurrent families serve through the same engine: ``--arch
xlstm-1.3b`` or ``--arch zamba2-2.7b`` (their slot state is prefilled at
each prompt's exact length; no prefix cache, sketch or speculation).

Observability: ``--trace-out trace.json`` records the request lifecycle
and the pump's host phases as Chrome trace-event JSON (open it in
Perfetto), ``--metrics-jsonl metrics.jsonl`` streams windowed metrics
every ``--metrics-interval`` seconds, and with ``--kv-sketch-window``
``--fidelity-every N`` samples the sketch-fidelity probe of folded slots
every N decode rounds.  An observer exists only when one of the first
two is given.  E.g.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --max-seq 512 --kv-sketch-window 64 --long-context 400 \
      --trace-out trace.json --metrics-jsonl metrics.jsonl
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time

import numpy as np

from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.obs import ServeObserver, Tracer
from repro_torch.serve.frontend import AsyncServeEngine
from repro_torch.serve.scheduler import Request


def make_request_stream(cfg, rng: np.random.RandomState, n_requests: int,
                        n_prefixes: int, prefix_len: int, max_tail: int,
                        max_new: int, rid0: int = 0,
                        sampled_frac: float = 0.0, temperature: float = 0.8,
                        top_k: int = 8):
    """Each request takes one of ``n_prefixes`` shared prefixes plus a
    random tail of 1..max_tail tokens; a ``sampled_frac`` fraction asks
    for seeded top-k sampling.  Draw for draw the reference's generator,
    so one seed gives both packages the same stream."""
    prefixes = rng.randint(0, cfg.vocab_size,
                           (n_prefixes, prefix_len)).astype(np.int32)
    reqs = []
    for i in range(n_requests):
        p = prefixes[rng.randint(n_prefixes)]
        tail = rng.randint(0, cfg.vocab_size,
                           size=rng.randint(1, max_tail + 1)).astype(np.int32)
        sampled = rng.rand() < sampled_frac
        reqs.append(Request(
            rid=rid0 + i, tokens=np.concatenate([p, tail]), max_new=max_new,
            temperature=temperature if sampled else 0.0,
            top_k=top_k if sampled else 0,
            seed=int(rng.randint(1 << 30)) if sampled else None))
    return reqs


async def stream_requests(front: AsyncServeEngine, reqs, rate: float,
                          cancel_frac: float,
                          rng: np.random.RandomState,
                          deadline_s: float = 0.0,
                          priority_frac: float = 0.0):
    """Submit ``reqs`` (all at once when ``rate`` is 0, else with
    exponential gaps of mean 1/rate s), stream every response, and hang
    up on a ``cancel_frac`` fraction of clients halfway through their
    budget.  A ``priority_frac`` fraction is submitted at priority 1 (it
    may preempt running priority-0 requests); ``deadline_s`` > 0 gives
    every request that SLO deadline.  Returns (completions,
    time-to-first-token seconds)."""
    results, ttfts = [], []

    async def consume(handle, t_submit, cancel_after):
        n = 0
        async for _tok in handle.stream():
            if n == 0:
                ttfts.append(time.monotonic() - t_submit)
            n += 1
            if cancel_after is not None and n >= cancel_after:
                handle.cancel()
        results.append(handle.completion)

    tasks = []
    for r in reqs:
        h = await front.submit(r.tokens, max_new=r.max_new,
                               temperature=r.temperature, top_k=r.top_k,
                               seed=r.seed, generator=r.generator,
                               spec_k=r.spec_k,
                               kv_sketch=r.kv_sketch,
                               priority=(1 if rng.rand() < priority_frac
                                         else 0),
                               deadline_s=max(0.0, deadline_s), rid=r.rid)
        cancel_after = (max(1, r.max_new // 2)
                        if rng.rand() < cancel_frac else None)
        tasks.append(asyncio.ensure_future(
            consume(h, time.monotonic(), cancel_after)))
        if rate > 0:
            await asyncio.sleep(float(rng.exponential(1.0 / rate)))
    await asyncio.gather(*tasks)
    return results, ttfts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths (default: reduced)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prefixes", type=int, default=3)
    ap.add_argument("--prefix-len", type=int, default=32)
    ap.add_argument("--max-tail", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--admit-threshold", type=int, default=2,
                    help="count-min frequency a prompt prefix needs before "
                         "its blocks are admitted to the prefix cache")
    ap.add_argument("--sampled-frac", type=float, default=0.25)
    ap.add_argument("--temperature", type=float, default=0.8,
                    help="temperature for the sampled fraction")
    ap.add_argument("--top-k", type=int, default=8,
                    help="top-k cutoff for the sampled fraction")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative draft tokens per verify round "
                         "(0 = plain decode)")
    ap.add_argument("--draft-depth", type=int, default=1,
                    help="layers kept in the derived draft proposer")
    ap.add_argument("--draft-sketch-ratio", type=int, default=0,
                    help="count-sketch-compress the draft's weights at this "
                         "ratio, with the FCS-sketched head (0 = dense "
                         "truncated draft)")
    ap.add_argument("--paged-kernels", choices=["auto", "on", "off"],
                    default="auto",
                    help="paged attention: the CUDA kernel ('on'), the "
                         "plain version ('off') or by device ('auto')")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrivals (req/s); 0 submits "
                         "everything at once")
    ap.add_argument("--cancel-frac", type=float, default=0.0)
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request SLO deadline in seconds; expired "
                         "requests surface partial output (0 = none)")
    ap.add_argument("--priority-frac", type=float, default=0.0,
                    help="fraction of requests submitted at priority 1 "
                         "(may preempt running priority-0 requests)")
    ap.add_argument("--kv-sketch-window", type=int, default=0,
                    help="exact recent-window rows per slot; older blocks "
                         "fold into per-slot FCS tail tables and free "
                         "(0 = whole context exact)")
    ap.add_argument("--kv-sketch-ratio", type=int, default=8,
                    help="sequence-axis compression of the tail tables "
                         "(cols ~ max_seq / ratio)")
    ap.add_argument("--kv-sketch-rows", type=int, default=3,
                    help="hash rows of the tail tables (median over rows)")
    ap.add_argument("--long-context", type=int, default=0,
                    help="append one request with a prompt of this many "
                         "tokens (fold-through prefill and two-span "
                         "decode; needs --kv-sketch-window)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON (load in "
                         "Perfetto / chrome://tracing) of the request "
                         "lifecycle and pump phases to this path")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="fraction of requests traced (deterministic "
                         "by rid); engine-level events always record")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append windowed metrics snapshots (counter "
                         "deltas/rates, latency quantiles, gauges) as "
                         "JSON lines to this path")
    ap.add_argument("--metrics-interval", type=float, default=0.5,
                    help="seconds between metrics windows")
    ap.add_argument("--fidelity-every", type=int, default=2,
                    help="sketch-fidelity probe cadence in decode "
                         "rounds (0 = off; needs --kv-sketch-window; "
                         "runs only at chunk boundaries)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    params = tf.init_params(cfg, seed=args.seed, device=dev)
    serve = dataclasses.replace(
        cfg.serve, max_batch=args.max_batch, max_seq=args.max_seq,
        admit_threshold=args.admit_threshold, prefix_block=args.prefix_len,
        spec_k=args.spec_k, draft_depth=args.draft_depth,
        draft_sketch_ratio=args.draft_sketch_ratio,
        kv_sketch_window=args.kv_sketch_window,
        kv_sketch_ratio=args.kv_sketch_ratio,
        kv_sketch_rows=args.kv_sketch_rows,
        paged_kernels={"auto": None, "on": True, "off": False}[
            args.paged_kernels])
    obs = None
    if args.trace_out or args.metrics_jsonl:
        obs = ServeObserver(
            tracer=(Tracer(sample_rate=args.trace_sample)
                    if args.trace_out else None),
            metrics_path=args.metrics_jsonl,
            metrics_interval=args.metrics_interval,
            fidelity_every=(args.fidelity_every
                            if args.kv_sketch_window > 0 else 0))
    t0 = time.perf_counter()
    front = AsyncServeEngine(cfg, params, serve=serve, device=dev, obs=obs)
    sched = front.scheduler
    if sched.draft is not None:
        print(f"draft: {sched.draft.cfg.num_layers} of {cfg.num_layers} "
              f"layers, sketch ratio {args.draft_sketch_ratio} "
              f"(sketched head: {sched.draft.cfg.sketch.sketched_head}); "
              f"engine built in {time.perf_counter() - t0:.3f}s")
    reqs = make_request_stream(cfg, np.random.RandomState(args.seed + 1),
                               args.requests, args.prefixes,
                               args.prefix_len, args.max_tail, args.max_new,
                               sampled_frac=args.sampled_frac,
                               temperature=args.temperature,
                               top_k=args.top_k)
    if args.long_context:
        if args.kv_sketch_window <= 0:
            raise ValueError("--long-context needs --kv-sketch-window")
        S = min(args.long_context, args.max_seq - args.max_new)
        rng_lc = np.random.RandomState(args.seed + 2)
        reqs.append(Request(
            rid=len(reqs),
            tokens=rng_lc.randint(0, cfg.vocab_size, (S,)).astype(np.int32),
            max_new=args.max_new))
    t0 = time.perf_counter()
    done, ttfts = asyncio.run(stream_requests(
        front, reqs, args.arrival_rate, args.cancel_frac,
        np.random.RandomState(args.seed + 3), deadline_s=args.deadline_s,
        priority_frac=args.priority_frac))
    dt = time.perf_counter() - t0
    toks = sum(len(c.tokens) for c in done)
    ttft = (f"{np.percentile(ttfts, 50) * 1e3:.1f} ms" if ttfts
            else "n/a (no token streamed)")
    print(f"device: {dev}; served {len(done)} requests / {toks} tokens in "
          f"{dt:.3f}s ({toks / dt:.1f} tok/s); ttft p50 {ttft}")
    statuses = {}
    for c in done:
        statuses[c.status] = statuses.get(c.status, 0) + 1
    if sched.is_kv:
        kernel = (sched.use_kernels if sched.use_kernels is not None
                  else dev.type == "cuda")
        print(f"statuses: {statuses}; paged attention: "
              f"{'CUDA kernel' if kernel else 'plain version'} "
              f"(--paged-kernels {args.paged_kernels})")
    else:
        print(f"statuses: {statuses}")
        print(f"recurrent family ({cfg.family}): slot-scheduled state, "
              f"prefix cache n/a; state {sched.kv_cache_bytes()} B")
    if sched.sketch_on:
        print(f"kv sketch: window={serve.kv_sketch_window} rows "
              f"(ratio={serve.kv_sketch_ratio}, rows={serve.kv_sketch_rows}"
              f", cols={sched.tail_cols}) — exact-window "
              f"{sched.kv_sketch_exact_bytes()}B live + sketched-tail "
              f"{sched.kv_sketch_tail_bytes()}B fixed")
    print(front.stats().format())
    if obs is not None:
        obs.close(stats=front.stats(), trace_path=args.trace_out)
        if args.trace_out:
            print(f"trace: {len(obs.tracer)} events -> {args.trace_out} "
                  f"(open in https://ui.perfetto.dev)")
        if args.metrics_jsonl:
            print(f"metrics: {len(obs.windows)} windows -> "
                  f"{args.metrics_jsonl}")


if __name__ == "__main__":
    main()
