"""The serving loop of a ``kind: serve`` mix: closed-loop clients of the
port's async front end.

Set-up builds the engine (``serve/frontend.py:AsyncServeEngine`` over a
``SlotScheduler`` with the mix's engine settings) on the seed's weights
and warms every chunk the traffic uses: a greedy and then a sampled
request, each past one prefill chunk and two decode chunks, so the
decode variants and the prefill chunk are captured before the clock
starts.  Then ``clients`` clients each submit a request, stream its
tokens and submit the next as soon as it completes, taking requests in
the run's order (``traffic.serve_requests``).  After ``ramp_s`` seconds
of load the window opens and lasts ``--seconds``; at its close the
clients stop and the requests still in flight are cancelled.

``output_tokens_per_s``: tokens streamed to the clients inside the
window, over the window.  ``ttft_p95_ms``: the 95th percentile, over
every request whose first token arrived in the window, of submit to
first token, on the client's clock.

After the window the engine is freed and the reference judges every
greedy request that completed, or a sample of them drawn from the seed
(``reference/serve.py``): a fault confined to one slot shows in the
requests that slot served.
"""
from __future__ import annotations

import asyncio
import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import devtrace, traffic, weights
from perfbench.common import sub_seed
from perfbench.harness import Context, Outcome
from perfbench.model_config import port_config
from perfbench.reference import serve as ref_serve


class Record:
    __slots__ = ("req", "t_sub", "first", "times", "handle", "completion")

    def __init__(self, req, t_sub):
        self.req, self.t_sub = req, t_sub
        self.first = None
        self.times: List[float] = []
        self.handle = None
        self.completion = None


def _chunks_inside(rec: Record, p0: float, p1: float) -> List[int]:
    """Context lengths of a request's tokens whose decode chunk ran inside
    [p0, p1]: tokens delivered together are one chunk, and a chunk counts
    when the one before it was delivered at p0 or later (the next chunk is
    dispatched only after that delivery) and it was delivered by p1."""
    out, prev, j = [], None, 0
    times = rec.times
    while j < len(times):
        k = j + 1
        while k < len(times) and times[k] - times[k - 1] < 1e-3:
            k += 1
        if prev is not None and prev >= p0 and times[k - 1] <= p1:
            out += [len(rec.req.prompt) + i for i in range(j, k)]
        prev, j = times[k - 1], k
    return out


def _mean_gap(judged) -> float:
    """The mean gap over every checked token (zeros included)."""
    return float(np.concatenate(judged)[:, 0].mean())


def _request_gap(judged) -> float:
    """The median over the checked requests of a request's mean gap."""
    return float(np.median([j[:, 0].mean() for j in judged]))


def _worst_rank(judged) -> float:
    """The most tokens the reference ranks above a checked token."""
    return float(np.concatenate(judged)[:, 1].max())


def _top(judged, col: int, n: int = 8) -> List[float]:
    """The ``n`` largest gaps (col 0) or ranks (col 1) over every checked
    token."""
    return [float(g) for g in np.sort(np.concatenate(judged)[:, col])[::-1][
        :n]]


def _longest_silence(recs, t0: float, t1: float) -> Dict[str, Any]:
    """The window's longest stretch in which no client received a token:
    its seconds, its start after t0, and the prompt lengths of the
    requests whose first token ended it."""
    t = np.sort(np.array([t0, t1] + [x for r in recs for x in r.times
                                     if t0 <= x <= t1]))
    i = int(np.argmax(np.diff(t)))
    end = t[i + 1]
    firsts = [len(r.req.prompt) for r in recs
              if r.first is not None and end <= r.first <= end + 0.1]
    return {"s": float(end - t[i]), "at_s": float(t[i] - t0),
            "first_tokens_after": firsts}


def _captures(engine) -> int:
    """CUDA graph captures so far, decode and prefill chunks."""
    st = engine.stats()
    return int(st.decode_compilations + st.prefill_compilations)


def _flip_share(judged) -> float:
    """The share of checked tokens that the reference would not pick."""
    return float((np.concatenate(judged)[:, 0] > 0).mean())


def _warm(engine, mix, conf, seed) -> None:
    """A greedy, then a sampled request through the engine: the prefill
    chunk and both decode variants are built before the clock starts."""
    ev = engine.scheduler.serve
    rng = np.random.RandomState(sub_seed(seed, "warm") % (1 << 32))
    n = ev.prefill_bucket + 3
    new = 2 * ev.decode_chunk

    async def go():
        for temp, k in ((0.0, 0), (mix.get("temperature", 1.0),
                                   mix.get("top_k", 0))):
            h = await engine.submit(
                rng.randint(0, conf["vocab_size"], n).astype(np.int32),
                max_new=new, temperature=temp, top_k=k, seed=1,
                deadline_s=0)
            await h.result()
    asyncio.run(go())


def _window(engine, reqs, mix, ctx, prof) -> Dict[str, Any]:
    sched = engine.scheduler
    records: List[Record] = []
    state = {"next": 0, "stop": False}

    def take():
        r = reqs[state["next"] % len(reqs)]
        state["next"] += 1
        return r

    async def client():
        while not state["stop"]:
            r = take()
            rec = Record(r, time.perf_counter())
            records.append(rec)
            h = await engine.submit(r.prompt, max_new=r.max_new,
                                    temperature=r.temperature,
                                    top_k=r.top_k, seed=r.sample_seed,
                                    deadline_s=0)
            rec.handle = h
            async for _ in h.stream():
                now = time.perf_counter()
                if rec.first is None:
                    rec.first = now
                rec.times.append(now)
            rec.completion = h.completion

    async def main():
        tasks = [asyncio.ensure_future(client())
                 for _ in range(mix["clients"])]
        await asyncio.sleep(mix["ramp_s"])
        t0 = time.perf_counter()
        marks = {"t0": t0, "chunks0": len(sched.chunk_ms),
                 "prefills0": len(sched.prefill_ms),
                 "captures0": _captures(engine)}
        prof_s = mix.get("trace", {}).get("profile_s", 0.0)
        traced = prof.enabled and prof_s
        if traced:
            # the stretch closes the window: reading the trace after stop()
            # holds the host a while
            await asyncio.sleep(max(0.0, t0 + ctx.seconds - prof_s
                                    - time.perf_counter()))
            prof.start()
            marks["p0"] = time.perf_counter()
            await asyncio.sleep(prof_s)
        await asyncio.sleep(max(0.0, t0 + ctx.seconds - time.perf_counter()))
        marks["t1"] = marks["p1"] = time.perf_counter()
        marks["chunks1"] = len(sched.chunk_ms)
        marks["prefills1"] = len(sched.prefill_ms)
        marks["captures1"] = _captures(engine)
        if traced:
            prof.stop()
        state["stop"] = True
        for rec in records:
            if rec.completion is None and rec.handle is not None:
                rec.handle.cancel()
        await asyncio.gather(*tasks)
        await engine.drain()
        return marks

    marks = asyncio.run(main())
    return {"records": records, **marks}


def run(ctx: Context) -> Outcome:
    from repro_torch.obs import ServeObserver, Tracer
    from repro_torch.serve.frontend import AsyncServeEngine
    conf, mix, dev = ctx.conf, ctx.mix, ctx.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    serve = dict(mix["engine"], seed=sub_seed(ctx.seed, "engine") % (1 << 31))
    cfg = port_config(conf, serve=serve)
    params = weights.port_params(conf, ctx.seed, dev)
    engine = AsyncServeEngine(cfg, params, device=dev)
    sched = engine.scheduler
    reqs = traffic.serve_requests(mix, conf["vocab_size"], ctx.seed)
    _warm(engine, mix, conf, ctx.seed)
    sched.prefill_chunk_ms()
    obs = None
    if ctx.trace:
        obs = ServeObserver(tracer=Tracer())
        sched.set_observer(obs)
        engine.obs = obs
    prof = devtrace.Profile(ctx.trace and cuda)
    prof.warm()
    w = _window(engine, reqs, mix, ctx, prof)
    t0, t1 = w["t0"], w["t1"]
    captured = w["captures1"] - w["captures0"]      # in the window: none
    setup_s = t0 - ctx.t_process
    recs: List[Record] = w["records"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    stats = engine.stats()
    chunk_ms = list(sched.chunk_ms)[w["chunks0"]:w["chunks1"]]
    prefill_ms = list(sched.prefill_ms)[w["prefills0"]:w["prefills1"]]

    inside = lambda t: t is not None and t0 <= t <= t1
    out_tokens = sum(sum(1 for t in r.times if inside(t)) for r in recs)
    ttft = [(r.first - r.t_sub) * 1e3 for r in recs if inside(r.first)]
    attempted = [r for r in recs if r.t_sub <= t1 and (
        r.completion is None or not r.times or r.times[-1] >= t0)]
    failed = sum(1 for r in attempted if r.completion is not None
                 and r.completion.status not in ("ok", "cancelled"))
    done_ok = [r for r in recs if r.completion is not None
               and r.completion.status == "ok"]
    short = sum(1 for r in done_ok
                if len(r.completion.tokens) != r.req.max_new)
    host_spans = None
    if obs is not None:
        host_spans = sum(
            min(e["ts"] + e["dur"], t1 * 1e6) - max(e["ts"], t0 * 1e6)
            for e in obs.tracer.events()
            if e.get("ph") == "X" and e["name"] in ("dispatch",
                                                     "prefill_chunk")
            and e["ts"] + e["dur"] >= t0 * 1e6 and e["ts"] <= t1 * 1e6) / 1e6
    prefilled = [(r.req, bool(r.completion.prefix_hit)
                  if r.completion is not None else True)
                 for r in recs if inside(r.first)]
    p0, p1 = w.get("p0"), w.get("p1")
    in_prof = (lambda t: p0 <= t <= p1) if p0 is not None else None
    decoded_ctx, prof_prefills = [], []
    if in_prof is not None:
        for r in recs:
            decoded_ctx += _chunks_inside(r, p0, p1)
            if r.t_sub >= p0 and r.first is not None and r.first <= p1:
                prof_prefills.append((r.req, bool(
                    r.completion.prefix_hit) if r.completion is not None
                    else True))
    decode_ctx_all = [len(r.req.prompt) + j for r in recs
                      for j, t in enumerate(r.times) if inside(t)]
    ctx.log(f"[serve] window {t1 - t0:.3f} s: {out_tokens} tokens, "
            f"{len(ttft)} first tokens, {len(done_ok)} completed, setup "
            f"{setup_s:.3f} s, peak {peak} B")

    # the check: every completed greedy request, or a sample of them
    # drawn from the seed with the longest in it
    greedy = [r for r in done_ok if r.req.temperature == 0.0]
    rng = np.random.RandomState(sub_seed(ctx.seed, "check") % (1 << 32))
    n_check = mix["check"]["requests"]
    pick = []
    if greedy:          # none completed: nothing served is shown sound
        longest = max(greedy, key=lambda r: len(r.completion.tokens))
        rest = [r for r in greedy if r is not longest]
        pick = [longest] + [rest[i] for i in rng.permutation(len(rest))[
            :n_check - 1]]
    sample = [(r.req.prompt, list(r.completion.tokens)) for r in pick]
    del engine, sched, params, w, obs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    # nothing checked reads as infinitely far from the reference
    judged = (ref_serve.gaps(conf, ctx.seed, dev, sample) if sample
            else [np.full((1, 2), np.inf)])
    per_request = [[len(j), float(j[:, 0].mean()),
                    float((j[:, 0] > 0).mean())] for j in judged]
    ctx.log(f"[serve] reference: {time.perf_counter() - t_ref:.3f} s over "
            f"{sum(len(s[1]) for s in sample)} served tokens of "
            f"{len(sample)} requests")
    numbers = {"request_logit_gap": _request_gap(judged),
               "worst_token_rank": _worst_rank(judged),
               "short_answers": float(short)}
    notes = {}
    if ctx.readings:
        # the control (float8 reference in the program's place) and the
        # fault of a token altered where it is produced, on this sample
        ctrl = ref_serve.gaps(conf, ctx.seed, dev, sample, control=True)
        altered = []
        for prompt, served in sample:
            toks = list(served)
            j = int(rng.randint(len(toks)))
            toks[j] = (toks[j] + 1 + int(rng.randint(conf["vocab_size"] - 1))
                       ) % conf["vocab_size"]
            altered.append((prompt, toks))
        alt = ref_serve.gaps(conf, ctx.seed, dev, altered)
        notes = {"control_top_gaps": _top(ctrl, 0),
                 "control_worst_rank": _worst_rank(ctrl),
                 "control_top_ranks": _top(ctrl, 1),
                 "control_mean_gap": _mean_gap(ctrl),
                 "control_request_gap": _request_gap(ctrl),
                 "control_flip_share": _flip_share(ctrl),
                 "altered_worst_rank": _worst_rank(alt),
                 "altered_top_ranks": _top(alt, 1),
                 "altered_mean_gap": _mean_gap(alt),
                 "altered_request_gap": _request_gap(alt)}
    return Outcome(
        e2e={"output_tokens_per_s": out_tokens / (t1 - t0),
             "ttft_p95_ms": float(np.percentile(ttft, 95)),
             "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        obs={"kind": "serve", "conf": conf, "mix": mix, "window_s": t1 - t0,
             "chunk_ms": chunk_ms, "prefill_ms": prefill_ms,
             "decode_chunk": mix["engine"]["decode_chunk"],
             "prefilled": prefilled, "host_span_s": host_spans,
             "decoded_ctx": decoded_ctx, "profiled_prefills": prof_prefills,
             "decode_ctx_window": decode_ctx_all,
             "kv_peak_reserved_bytes": stats.kv_peak_reserved_bytes,
             "profile": prof.summary},
        checks=[(k, v, ctx.limits[k]) for k, v in numbers.items()],
        attempted=len(attempted), failed=failed, memory_peak_bytes=peak,
        profile=prof.summary,
        notes={**notes, "mean_gap": _mean_gap(judged),
               "top_gaps": _top(judged, 0),
               "top_ranks": _top(judged, 1),
               "checked_requests": len(sample),
               "completed_greedy": len(greedy),
               "flip_share": _flip_share(judged),
               "requests_len_mean_flips": per_request,
               "requests_in_window": len(ttft), "completed": len(done_ok),
               "longest_silence": _longest_silence(recs, t0, t1),
               "captures_in_window": captured,
               "checked_tokens": sum(len(s[1]) for s in sample),
               "reference_s": time.perf_counter() - t_ref,
               "prefix_hits": stats.prefix_hits,
               "prefix_lookups": stats.prefix_lookups})
