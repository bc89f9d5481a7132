"""Port parity: the serve path's observability (``repro_torch.obs`` and the
hooks of the port's scheduler, prefix cache, front end and engine) against
the JAX package's ``repro.obs``, on reduced gemma-2b with the reference's
parameters carried across by models/bridge.py.

Tolerances.  The metrics, tracer and exporters are the same Python
arithmetic in both packages: histogram windows and quantiles agree within
1e-12, Prometheus text byte for byte, JSONL lines and trace events up to
their clock fields.  Through the engines every count is integer
bookkeeping and must be equal: the final totals of every ``serve.*``,
``prefix.*`` and ``spec.*`` counter and of every ``engine.*`` counter
(less the compilation counts, which count XLA compilations in the
reference and CUDA graph captures in the port, 0 on the CPU), the samples
of each histogram, and the sequence of trace events reduced to
(ph, name, cat, id, args) with timestamps, durations and the fidelity
probe's spread dropped.  The speculative stream uses an "exact" draft
(the target's upper layer zeroed, so the draft is the target in each
package), since acceptance counts follow the tokens and a near-tie may
flip a token between the packages.  The fidelity probe's spread is held
within 1e-4 relative of the reference's ``tail_row_spread`` at the same
folded state (the port's tail tables fed through numpy): the two sum the
same f32 energies in different orders.
"""
import ast
import asyncio
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.configs.registry import reduced_config as ref_reduced
from repro.launch.serve import make_request_stream as ref_stream
from repro.models import transformer as rtf
from repro.serve import kv_sketch as rkvs
from repro.serve.frontend import AsyncServeEngine as RefFrontend
from repro.serve.scheduler import EngineStats as RefEngineStats
from repro.serve.scheduler import Request as RefRequest
from repro.serve.scheduler import SlotScheduler as RefScheduler
from repro_torch import obs as tobs
from repro_torch.configs.registry import reduced_config
from repro_torch.launch import serve as launch
from repro_torch.launch.serve import make_request_stream
from repro_torch.models import bridge
from repro_torch.serve import kv_sketch as kvs
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.frontend import AsyncServeEngine
from repro_torch.serve.scheduler import EngineStats, Request, SlotScheduler

torch.set_num_threads(1)

QUANTILE_TOL = 1e-12
SPREAD_RTOL = 1e-4
# counts that differ by design: XLA compilations vs CUDA graph captures
COMPILATIONS = ("engine.decode_compilations", "engine.prefill_compilations")
OBS_DIR = pathlib.Path(__file__).resolve().parents[1] / "src" / \
    "repro_torch" / "obs"


@pytest.fixture(scope="module")
def gemma():
    cfg, tcfg = ref_reduced("gemma-2b"), reduced_config("gemma-2b")
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return cfg, params, tcfg, tparams


def _serve(cfg, **kw):
    base = dict(max_batch=3, max_seq=96, decode_chunk=4, prefill_bucket=16)
    base.update(kw)
    return dataclasses.replace(cfg.serve, **base)


def _prompts(cfg, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _observers(sample_rate=1.0, **kw):
    """A full observer of each package: (reference's, port's)."""
    return tuple(m.ServeObserver(tracer=m.Tracer(sample_rate=sample_rate),
                                 metrics_interval=0.0, **kw)
                 for m in (robs, tobs))


def _reduced(events):
    """Trace events without their clock fields or probe values."""
    out = []
    for e in events:
        args = {k: v for k, v in e.get("args", {}).items() if k != "spread"}
        out.append((e["ph"], e["name"], e.get("cat"), e.get("id"), args))
    return out


def _lines_without_clock(path):
    """JSONL windows with ``ts``, ``dur_s`` and each rate (delta / dur_s)
    dropped, after checking each rate against its delta."""
    out = []
    for ln in pathlib.Path(path).read_text().splitlines():
        w = json.loads(ln)
        dur = w.pop("dur_s")
        w.pop("ts")
        for c in w["counters"].values():
            assert c.pop("rate") == pytest.approx(c["delta"] / dur)
        out.append(w)
    return out


# ---------------------------------------------------------------------------
# metrics, tracer and exporters: the same calls give the same output
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hist_kw,dist", [
    ({}, "lognormal"),
    ({}, "with_zeros_and_overflow"),
    (dict(lo=1e-3, hi=10.0, growth=2.0), "lognormal"),
])
def test_histogram_windows_equal_reference(hist_kw, dist):
    rng = np.random.RandomState(0)
    xs = np.exp(rng.randn(4000) * 1.5 - 3.0)
    if dist == "with_zeros_and_overflow":
        xs[::7] = 0.0
        xs[::11] = 1e9
    regs = (robs.MetricsRegistry(), tobs.MetricsRegistry())
    for part in np.array_split(xs, 5):
        for reg in regs:
            h = reg.hist("lat", **hist_kw)
            for x in part:
                h.observe(float(x))
        wr, wt = (reg.window()["hists"]["lat"] for reg in regs)
        assert (wr["count"], wr["sum"], wr["max"]) == \
            (wt["count"], wt["sum"], wt["max"])
        for q in ("p50", "p90", "p99"):
            assert abs(wr[q] - wt[q]) <= QUANTILE_TOL * max(abs(wr[q]), 1)
    hr, ht = (reg.hists["lat"] for reg in regs)
    assert hr.counts == ht.counts and hr.bounds == ht.bounds
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert abs(hr.quantile(q) - ht.quantile(q)) <= \
            QUANTILE_TOL * max(abs(hr.quantile(q)), 1)


def _fill(reg, stats):
    reg.counter("serve.tokens_committed").inc(17)
    reg.counter("prefix.hit").inc()
    reg.counter("serve.completions.ok").inc(3)
    reg.gauge("serve.queue_depth").set(4)
    reg.gauge("kv.tail_spread.slot1").set(0.125)
    for x in (0.001, 0.02, 0.3, 0.3, 4.0):
        reg.hist("serve.ttft_s").observe(x)
    reg.update_from_stats(stats)


def test_prometheus_text_and_jsonl_equal_reference(tmp_path):
    fields = dict(completed=7, blocks_peak=3, queue_depth=2, block_size=16,
                  fold_rows=96, spec_accepted=5)
    regs = (robs.MetricsRegistry(), tobs.MetricsRegistry())
    paths = (tmp_path / "ref.jsonl", tmp_path / "port.jsonl")
    for mod, reg, stats, path in zip(
            (robs, tobs), regs,
            (RefEngineStats(**fields), EngineStats(**fields)), paths):
        sink = mod.MetricsJsonlWriter(str(path))
        _fill(reg, stats)
        sink.write(reg.window())
        reg.counter("serve.tokens_committed").inc(5)
        reg.hist("serve.ttft_s").observe(0.5)
        sink.write(reg.window())
        sink.close()
        assert sink.written == 2
    for ns in ("repro", "port"):
        assert tobs.prometheus_text(regs[1], ns) == \
            robs.prometheus_text(regs[0], ns)
    assert _lines_without_clock(paths[1]) == _lines_without_clock(paths[0])
    assert EngineStats.field_kinds() == RefEngineStats.field_kinds()


@pytest.mark.parametrize("rate", [0.05, 0.5, 1.0])
def test_trace_sampling_equal_reference(rate):
    rt, tt = robs.Tracer(sample_rate=rate), tobs.Tracer(sample_rate=rate)
    got = {rid for rid in range(10_000) if tt.sampled(rid)}
    assert got == {rid for rid in range(10_000) if rt.sampled(rid)}
    assert 0.5 * rate * 10_000 < len(got) <= 10_000


def test_tracer_overflow_and_trace_file_equal_reference(tmp_path):
    files = []
    for mod in (robs, tobs):
        tr = mod.Tracer(sample_rate=1.0, max_events=10)
        for i in range(30):
            tr.begin_async("request", i, f"req{i}", {"prompt_len": i})
            tr.complete("dispatch", tr.now(), 2.5, {"i": i})
            tr.instant("fold", {"slot": i % 3, "rows": 16})
            tr.counter("engine", {"queue_depth": i})
            tr.end_async("request", i, f"req{i}")
        assert (len(tr), tr.dropped) == (10, 140)
        path = tmp_path / f"{mod.__name__}.json"
        assert mod.write_trace(tr, str(path)) == 11
        files.append(json.loads(path.read_text()))
    ref, got = files
    assert got["displayTimeUnit"] == ref["displayTimeUnit"]
    assert _reduced(got["traceEvents"]) == _reduced(ref["traceEvents"])
    assert got["traceEvents"][-1]["args"] == {"dropped": 140}


def _script(o):
    """Every ServeObserver hook, in a pump-like order."""
    for rid in range(6):
        o.request_queued(rid, 10 + rid, rid % 2)
    o.backpressure_wait(0.002)
    for rid in range(3):
        o.prefix_event("miss" if rid else "hit")
        o.prefill_span(rid, 0, 16, 0.001)
        o.request_admitted(rid, rid, rid == 0)
    o.admission_deferred(3)
    o.prefix_event("defer")
    o.pump_span("dispatch", 1.0, 0.003)
    o.fold(1, 32)
    o.spec_round(0, 2, 1)
    o.spec_round(1, 2, 2)
    o.pump_span("collect", 1.1, 0.02)
    o.chunk_collected(9, 3, 3)
    o.fidelity(1, 1, 32, 0.0625)
    o.maybe_flush()
    o.tokens_delivered(0, 3)
    o.tokens_delivered(1, 0)
    o.tokens_delivered(1, 3)
    o.request_preempted(2, 2, 3)
    o.request_finished(0, "ok", 6)
    o.tokens_delivered(0, 2)
    o.prefix_event("admit")
    o.prefix_event("evict")
    o.request_finished(5, "cancelled", 0)
    o.tokens_delivered(1, 3)
    o.request_finished(1, "expired", 4)


@pytest.mark.parametrize("sample_rate", [1.0, 0.5])
def test_observer_hooks_equal_reference(sample_rate):
    ro, to = _observers(sample_rate)
    for o in (ro, to):
        _script(o)
        o.flush()
    rr, tr = ro.registry, to.registry
    assert {n: c.value for n, c in tr.counters.items()} == \
        {n: c.value for n, c in rr.counters.items()}
    assert {n: g.value for n, g in tr.gauges.items()} == \
        {n: g.value for n, g in rr.gauges.items()}
    assert {n: h.count for n, h in tr.hists.items()} == \
        {n: h.count for n, h in rr.hists.items()}
    assert _reduced(to.tracer.events()) == _reduced(ro.tracer.events())
    assert len(to.windows) == len(ro.windows) == 2


def test_obs_package_imports_no_torch_and_nothing_of_the_reference():
    for path in sorted(OBS_DIR.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("torch", "jax", "repro", "numpy"), \
                    (path.name, n)


# ---------------------------------------------------------------------------
# engines: the same stream through both packages' observed engines
# ---------------------------------------------------------------------------


def _waiting_reference(cfg, params, serve):
    """The reference's scheduler, made to wait for its prefill and fold
    computations (tests/test_torch_kv_sketch_serve.py: on the CPU its
    in-place edits of numpy table rows may race a queued computation)."""
    rs = RefScheduler(cfg, params, serve=serve)
    for name in ("_prefill_chunk", "_fold_fn"):
        fn = getattr(rs, name, None)
        if fn is None:                # a sketch-free engine folds nothing
            continue

        def waiting(*a, _fn=fn):
            return jax.block_until_ready(_fn(*a))

        waiting._cache_size = fn._cache_size    # read by the stats
        setattr(rs, name, waiting)
    return rs


async def _drive(front, reqs):
    """Submit every request at once through an async front end, stream
    them all; returns ({rid: streamed tokens}, completion order)."""
    handles = [await front.submit(
        r.tokens, max_new=r.max_new, temperature=r.temperature,
        top_k=r.top_k, seed=r.seed, kv_sketch=r.kv_sketch, deadline_s=0,
        rid=r.rid) for r in reqs]

    async def take(h):
        return [int(t) async for t in h.stream()]

    outs = await asyncio.gather(*(take(h) for h in handles))
    return {h.rid: o for h, o in zip(handles, outs)}


def _exact_draft_params(params):
    """The target with its upper layer zeroed: a depth-1 truncated draft
    is then the target in each package, so every proposal is accepted."""
    blocks = dict(params["blocks"])
    blocks["attn"] = dict(blocks["attn"],
                          wo=blocks["attn"]["wo"].at[1:].set(0))
    blocks["ffn"] = dict(blocks["ffn"],
                         w_down=blocks["ffn"]["w_down"].at[1:].set(0))
    return dict(params, blocks=blocks)


def _stream(name, cfg, params, tcfg, tparams):
    """(reference params, port params, reference serve, port serve,
    reference requests, port requests, observer knobs) of one stream."""
    if name == "plain":
        stream = (12, 3, 32, 24, 8)
        rreqs = ref_stream(cfg, np.random.RandomState(5), *stream,
                           sampled_frac=0.25)
        treqs = make_request_stream(tcfg, np.random.RandomState(5), *stream,
                                    sampled_frac=0.25)
        return (params, tparams, _serve(cfg), _serve(tcfg), rreqs, treqs,
                {})
    if name == "sketched":
        bs = cfg.serve.kv_block_size
        kw = dict(max_batch=2, max_seq=256, num_kv_blocks=24,
                  kv_sketch_window=2 * bs)
        lens = [140, 17, 100]
        prompts = _prompts(cfg, lens, seed=9)
        rreqs = [RefRequest(rid=i, tokens=p, max_new=6,
                            kv_sketch=False if i == 1 else None)
                 for i, p in enumerate(prompts)]
        treqs = [Request(rid=i, tokens=p, max_new=6,
                         kv_sketch=False if i == 1 else None)
                 for i, p in enumerate(prompts)]
        return (params, tparams, _serve(cfg, **kw), _serve(tcfg, **kw),
                rreqs, treqs, dict(fidelity_every=1))
    params = _exact_draft_params(params)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    kw = dict(spec_k=2, draft_depth=1, prefix_block=16, kv_block_size=16,
              admit_threshold=2)
    # 9 new tokens: three whole rounds of spec_k + 1, so with the exact
    # draft every proposal is accepted
    stream = (10, 2, 32, 16, 9)
    rreqs = ref_stream(cfg, np.random.RandomState(6), *stream)
    treqs = make_request_stream(tcfg, np.random.RandomState(6), *stream)
    return (params, tparams, _serve(cfg, **kw), _serve(tcfg, **kw), rreqs,
            treqs, {})


@pytest.fixture(scope="module", params=["plain", "sketched", "spec"])
def observed(request, gemma):
    """One stream through the reference's and the port's async engines,
    each with a full observer (every request traced, a metrics window
    every round), and through the port's engine without one."""
    cfg, params, tcfg, tparams = gemma
    rp, tp, rsv, tsv, rreqs, treqs, knobs = _stream(request.param, *gemma)
    ro, to = _observers(**knobs)
    rs = _waiting_reference(cfg, rp, rsv)
    rtoks = asyncio.run(_drive(RefFrontend(scheduler=rs, obs=ro), rreqs))
    ts = SlotScheduler(tcfg, tp, serve=tsv, device="cpu")
    ttoks = asyncio.run(_drive(AsyncServeEngine(scheduler=ts, obs=to),
                               treqs))
    off = SlotScheduler(tcfg, tp, serve=tsv, device="cpu")
    otoks = asyncio.run(_drive(AsyncServeEngine(scheduler=off), treqs))
    for o, s in ((ro, rs), (to, ts)):
        o.flush(s.stats)
    return dict(name=request.param, ro=ro, to=to, rs=rs, ts=ts, off=off,
                rtoks=rtoks, ttoks=ttoks, otoks=otoks, treqs=treqs)


def test_engine_counters_equal_reference(observed):
    rr, tr = observed["ro"].registry, observed["to"].registry
    ref = {n: c.value for n, c in rr.counters.items()
           if n not in COMPILATIONS}
    got = {n: c.value for n, c in tr.counters.items()
           if n not in COMPILATIONS}
    assert got == ref
    assert {n: h.count for n, h in tr.hists.items()} == \
        {n: h.count for n, h in rr.hists.items()}
    assert set(tr.gauges) == set(rr.gauges)
    # every window's counter deltas, round by round
    assert len(observed["to"].windows) == len(observed["ro"].windows)
    for wr, wt in zip(observed["ro"].windows, observed["to"].windows):
        assert {n: c["delta"] for n, c in wt["counters"].items()
                if n not in COMPILATIONS} == \
            {n: c["delta"] for n, c in wr["counters"].items()
             if n not in COMPILATIONS}
    # the stream reached what it was chosen for
    name = observed["name"]
    assert got["serve.decode_rounds"] > 0
    if name == "plain":
        assert got["prefix.hit"] > 0 and got["prefix.admit"] > 0
    if name == "sketched":
        assert got["serve.fold_rows"] > 0 and tr.hists["kv.tail_spread"].count
    if name == "spec":
        assert got["spec.accepted"] == got["spec.proposed"] > 0


def test_trace_events_equal_reference(observed):
    ref = _reduced(observed["ro"].tracer.events())
    got = _reduced(observed["to"].tracer.events())
    assert len(got) == len(ref) > 0
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, (i, a, b)
    names = {e[1] for e in got}
    assert {"dispatch", "collect", "prefill_chunk", "engine"} <= names


def test_observer_changes_no_token(observed):
    ts, off = observed["ts"], observed["off"]
    assert observed["ttoks"] == observed["otoks"]
    assert [c.rid for c in ts.completed] == [c.rid for c in off.completed]
    assert ts.stats() == off.stats()
    assert (ts.alloc.rc.tolist(), sorted(ts.alloc._free)) == \
        (off.alloc.rc.tolist(), sorted(off.alloc._free))
    # and the reference served the same schedule
    assert [c.rid for c in ts.completed] == \
        [c.rid for c in observed["rs"].completed]


def test_windowed_engine_counters_sum_to_engine_stats(observed):
    to, ts = observed["to"], observed["ts"]
    final = ts.stats()
    wins = to.windows
    for f, kind in EngineStats.field_kinds().items():
        if kind != "counter":
            continue
        total = sum(w["counters"].get(f"engine.{f}", {"delta": 0.0})["delta"]
                    for w in wins)
        assert total == float(getattr(final, f)), f
    served = sum(len(t) for t in observed["ttoks"].values())
    for name in ("serve.tokens_delivered", "serve.tokens_committed"):
        assert sum(w["counters"].get(name, {"delta": 0})["delta"]
                   for w in wins) == served, name
    last = wins[-1]["counters"]
    assert last["serve.completions.ok"]["total"] == final.completed
    assert last.get("prefix.hit", {"total": 0})["total"] == \
        final.prefix_hits
    assert last["serve.prefill_chunks"]["total"] > 0
    assert last.get("serve.fold_rows", {"total": 0})["total"] == \
        final.fold_rows
    assert last.get("spec.rounds", {"total": 0})["total"] == \
        final.spec_rounds


def test_async_spans_balanced_and_nested(observed, tmp_path):
    path = tmp_path / "trace.json"
    n = tobs.write_trace(observed["to"].tracer, str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    assert len(ev) == n > 0
    for e in ev:
        assert e["ph"] in ("b", "e", "X", "i", "C") and e["pid"] == 1
        if e["ph"] == "X":
            assert e["dur"] >= 0
    for rid in observed["ttoks"]:
        spans = [e for e in ev if e["ph"] in ("b", "e")
                 and e["id"] == rid]
        for name in (f"req{rid}", "active"):
            named = [e["ph"] for e in spans if e["name"] == name]
            assert named.count("b") == named.count("e") >= 1, (rid, name)
        req = [e["ts"] for e in spans if e["name"] == f"req{rid}"]
        assert all(min(req) <= e["ts"] <= max(req) for e in spans)


# ---------------------------------------------------------------------------
# the fidelity probe, detaching, the engine facade and the launcher
# ---------------------------------------------------------------------------


def _long_request(tcfg, tparams):
    """A one-slot sketched engine and a request that folds: (engine, the
    request's tokens served by ``run(sched)``)."""
    bs = tcfg.serve.kv_block_size
    sv = _serve(tcfg, max_batch=1, max_seq=256, num_kv_blocks=24,
                kv_sketch_window=2 * bs)
    sched = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    (p,) = _prompts(tcfg, [150], seed=0)
    run = lambda: list(sched.run([Request(rid=0, tokens=p,
                                          max_new=9)])[0].tokens)
    return sched, run


def test_fidelity_probe_matches_reference_function(gemma):
    """With ``fidelity_every=1`` every collected round reports the folded
    slot's spread, equal (within SPREAD_RTOL) to the reference's
    ``tail_row_spread`` of the port's tail tables at that moment."""
    _, _, tcfg, tparams = gemma
    sched, run = _long_request(tcfg, tparams)
    seen = []

    class Recording(tobs.ServeObserver):
        def fidelity(self, slot, rid, fold_rows, spread):
            tail = sched._state.cache["tail"].numpy().copy()
            seen.append((slot, fold_rows, spread, tail))
            super().fidelity(slot, rid, fold_rows, spread)

    obs = Recording(metrics_interval=0.0, fidelity_every=1)
    sched.set_observer(obs)
    run()
    assert sched.fold_rows_total > 0 and len(seen) >= 2
    for slot, fold_rows, spread, tail in seen:
        assert slot == 0 and fold_rows > 0
        ref = float(np.asarray(rkvs.tail_row_spread(
            {"k": jnp.asarray(tail[0]), "v": jnp.asarray(tail[1])}))[slot])
        assert ref > 0
        assert abs(spread - ref) <= SPREAD_RTOL * ref, (spread, ref)
    w = obs.flush()
    assert w["gauges"]["kv.tail_spread.slot0"] == seen[-1][2]
    assert obs.registry.hist("kv.tail_spread").count == len(seen)


def test_fidelity_probe_off_never_runs(gemma, monkeypatch):
    _, _, tcfg, tparams = gemma
    sched, run = _long_request(tcfg, tparams)
    sched.set_observer(tobs.ServeObserver(metrics_interval=0.0,
                                          fidelity_every=1))
    want = run()

    def refuse(tail):
        raise AssertionError("probe ran with fidelity_every == 0")

    monkeypatch.setattr(kvs, "tail_row_spread", refuse)
    sched, run = _long_request(tcfg, tparams)
    obs = tobs.ServeObserver(metrics_interval=0.0)      # fidelity_every=0
    sched.set_observer(obs)
    got = run()
    assert got == want and sched.fold_rows_total > 0
    w = obs.flush()
    assert not any(k.startswith("kv.tail_spread") for k in w["gauges"])
    assert "kv.tail_spread" not in w["hists"]


def test_set_observer_none_detaches(gemma):
    _, _, tcfg, tparams = gemma
    obs = tobs.ServeObserver(tracer=tobs.Tracer(), metrics_interval=0.0)
    sched = SlotScheduler(tcfg, tparams, serve=_serve(tcfg), device="cpu",
                          obs=obs)
    assert sched.obs is obs and sched.prefix_cache.obs is obs
    assert AsyncServeEngine(scheduler=sched).obs is obs
    sched.set_observer(None)
    assert sched.obs is None and sched.prefix_cache.obs is None
    front = AsyncServeEngine(scheduler=sched)
    assert front.obs is None
    prompts = _prompts(tcfg, [40, 40, 20], seed=3)
    asyncio.run(_drive(front, [Request(rid=i, tokens=p, max_new=3)
                               for i, p in enumerate(prompts)]))
    assert len(sched.completed) == 3
    assert not obs.registry.counters and len(obs.tracer) == 0


def test_backpressure_wait_is_observed(gemma):
    """A submit that waits for queue space reports the stall and its wait
    (``queue_depth`` 1, four requests submitted one after another)."""
    _, _, tcfg, tparams = gemma
    obs = tobs.ServeObserver(metrics_interval=0.0)
    front = AsyncServeEngine(tcfg, tparams,
                             serve=_serve(tcfg, queue_depth=1),
                             device="cpu", obs=obs)
    assert front.scheduler.obs is obs
    reqs = [Request(rid=i, tokens=p, max_new=2)
            for i, p in enumerate(_prompts(tcfg, [20] * 4, seed=6))]
    toks = asyncio.run(_drive(front, reqs))
    assert sorted(toks) == [0, 1, 2, 3]
    assert all(len(t) == 2 for t in toks.values())
    stalls = obs.registry.counters["serve.backpressure_stalls"].value
    assert stalls >= 1
    assert obs.registry.hists["serve.backpressure_wait_s"].count == stalls


def test_serve_engine_observer_reaches_every_scheduler(gemma):
    _, _, tcfg, tparams = gemma
    prompts = np.stack(_prompts(tcfg, [20, 20], seed=4))
    eng = ServeEngine(tcfg, tparams, max_seq=64, device="cpu")
    eng.generate(prompts, max_new=2)                    # before attaching
    obs = tobs.ServeObserver(tracer=tobs.Tracer(), metrics_interval=0.0)
    eng.set_observer(obs)
    eng.generate(prompts, max_new=3)                    # the live scheduler
    eng.generate(prompts[:1], max_new=3)                # a new one
    c = obs.registry.counters
    assert c["serve.requests_submitted"].value == 3
    assert c["serve.tokens_delivered"].value == 9
    assert c["serve.completions.ok"].value == 3
    assert eng.stats().completed == 5
    eng.set_observer(None)
    eng.generate(prompts, max_new=2)
    assert c["serve.requests_submitted"].value == 3
    # given at construction, it reaches the schedulers the engine builds
    obs2 = tobs.ServeObserver(metrics_interval=0.0)
    ServeEngine(tcfg, tparams, max_seq=64, device="cpu",
                obs=obs2).generate(prompts, max_new=2)
    assert obs2.registry.counters["serve.tokens_delivered"].value == 4


def test_launcher_writes_trace_and_metrics(tmp_path, capsys):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.jsonl"
    # the long request outlives its first rounds (20 new at 8 a round),
    # so the probe samples its folded slot
    launch.main(["--device", "cpu", "--requests", "3", "--max-new", "20",
                 "--max-seq", "256", "--kv-sketch-window", "32",
                 "--kv-sketch-rows", "2", "--long-context", "200",
                 "--trace-out", str(trace), "--metrics-jsonl",
                 str(metrics), "--metrics-interval", "0",
                 "--fidelity-every", "1"])
    out = capsys.readouterr().out
    ev = json.loads(trace.read_text())["traceEvents"]
    lines = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert f"trace: {len(ev)} events -> {trace}" in out
    assert f"metrics: {len(lines)} windows -> {metrics}" in out
    assert lines[-1]["counters"]["serve.completions.ok"]["total"] == 4
    assert lines[-1]["counters"]["engine.fold_rows"]["total"] > 0
    assert any(k.startswith("kv.tail_spread.slot") for k in
               lines[-1]["gauges"])
    assert {"dispatch", "collect", "prefill_chunk"} <= \
        {e["name"] for e in ev if e["ph"] == "X"}
