"""Port parity: request streams of the recurrent families (reduced
xlstm-1.3b and zamba2-2.7b) through the JAX package's slot scheduler and
``repro_torch``'s, with the reference's parameters, and through the
port's own full recompute.

Scheduling is integer bookkeeping and must be equal: completion order
and every ``EngineStats`` field but the capture counts (XLA compilations
in the reference: one decode, one prefill per distinct prompt length;
CUDA graph captures in the port, which runs eagerly on the CPU and
prefills eagerly everywhere).  Greedy tokens are compared step by step
while the oracle's teacher-forced top-1 margin exceeds the tolerance;
past a smaller margin a near-tie may flip and the contexts part.

Two precisions.  In f32 (``f32`` fixture: the reference's bf16 casts
patched to f32, f32 weights and slot state in both engines) the packages
compute one function to ~1e-5 of max|logit|, so ``F32_MARGIN`` compares
nearly every token.  In bf16, as served, a random-weight reduced xLSTM
amplifies rounding through its layers (tests/test_torch_ssm.py): the
recurrent (decode) and parallel (prefill, training) forms of either
package round apart by up to ~20% of max|logit| over 8 tokens
(``tools/recurrent_drift.py --device cpu --reduced``), so ``BF16_MARGIN``
compares only clear choices.  This is why the reference's own
``tests/test_serve_engine.py::test_recurrent_slot_stream_matches_recompute``
fails: it compares greedy tokens with no margin guard, and on the
1-token prompt [396] (rid 2 of its xlstm stream) the decode step from a
zero state and the 1-token forward order a one-ulp bf16 tie differently
(451 at 3.0625 and 67 at 3.046875 in the forward, the reverse in the
decode step), so the recompute says 451 where the engine serves 67.
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.configs.registry import reduced_config as ref_reduced
from repro.models import layers as rly
from repro.models import ssm as rssm
from repro.models import transformer as rtf
from repro.serve import scheduler as rsched
from repro.serve.scheduler import Request as RefRequest
from repro.serve.scheduler import SlotScheduler as RefScheduler
from repro_torch import obs as tobs
from repro_torch.configs.registry import reduced_config
from repro_torch.launch import serve as launch
from repro_torch.models import bridge
from repro_torch.models import layers as ly
from repro_torch.models import transformer as tf
from repro_torch.serve import graphs as gr
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.frontend import AsyncServeEngine
from repro_torch.serve.scheduler import Request, SlotScheduler

torch.set_num_threads(1)

ARCHS = ["xlstm-1.3b", "zamba2-2.7b"]
F32_MARGIN = 1e-3
BF16_MARGIN = {"xlstm-1.3b": 1.0, "zamba2-2.7b": 0.3}
# the counts that differ by design: XLA compilations vs graph captures
CAPTURES = ("decode_compilations", "prefill_compilations")
# prompt lengths: the conv stash's edges, a 1-token prompt, slot reuse
# (six requests through two slots)
LENS = (6, 11, 1, 9, 3, 2)


def _serve(cfg, **kw):
    base = dict(max_batch=2, max_seq=48, decode_chunk=4)
    base.update(kw)
    return dataclasses.replace(cfg.serve, **base)


def _requests(cfg, make, lens=LENS, max_new=5, sampled=(4,), seed=0):
    rng = np.random.RandomState(seed)
    return [make(rid=i, tokens=rng.randint(0, cfg.vocab_size, (n,)).astype(
        np.int32), max_new=max_new,
        temperature=0.9 if i in sampled else 0.0,
        top_k=5 if i in sampled else 0,
        seed=100 + i if i in sampled else None)
        for i, n in enumerate(lens)]


@pytest.fixture
def f32(monkeypatch):
    """Both engines in f32: the reference's bf16 casts and its slot
    state's dtype patched to f32 (the port's slot state takes its f32
    weights' dtype)."""
    monkeypatch.setattr(rly, "PDTYPE", jnp.float32)
    monkeypatch.setattr(rssm, "PDTYPE", jnp.float32)
    ref_init = rtf.init_cache
    monkeypatch.setattr(rsched.tf, "init_cache",
                        lambda *a, **k: ref_init(*a, dtype=jnp.float32))


def _params(arch, f32=False):
    cfg, tcfg = ref_reduced(arch), reduced_config(arch)
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return cfg, params, tcfg, bridge.from_reference(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")


def _margins(logits, S, n):
    """Top-1 margins and argmaxes of rows S - 1 .. S - 2 + n."""
    lg = np.asarray(logits, np.float32)[S - 1:S - 1 + n]
    srt = np.sort(lg, axis=-1)
    return srt[:, -1] - srt[:, -2], lg.argmax(-1)


def _ref_logits(cfg, params, seq):
    y, _, _ = rtf.forward(params, rtf.embed_inputs(
        params, {"tokens": jnp.asarray(seq)[None]}, cfg), cfg, mode="train")
    return np.asarray(rly.logits_fn(params, y, cfg))[0, :, :cfg.vocab_size]


def _port_logits(tcfg, tparams, seq):
    with torch.no_grad():
        y, _ = tf.forward(tparams, tf.embed_inputs(
            tparams, torch.as_tensor(seq, dtype=torch.int64)[None]), tcfg)
        return ly.logits_fn(tparams, y, tcfg)[0, :, :tcfg.vocab_size].numpy()


def _compare_above_margin(reqs, got, want, logits_of, margin):
    """Tokens of greedy requests equal step by step while the oracle's
    (``logits_of(seq)``, teacher-forced on ``want``'s tokens) top-1
    margin exceeds ``margin``.  Returns the tokens compared."""
    compared = 0
    for r in reqs:
        if r.temperature:
            continue
        w = want[r.rid]
        seq = np.concatenate([r.tokens, w[:-1]])
        m, _ = _margins(logits_of(seq), len(r.tokens), len(w))
        n = int(np.argmax(m < margin)) if (m < margin).any() else len(m)
        np.testing.assert_array_equal(got[r.rid][:n], w[:n],
                                      err_msg=f"rid {r.rid}")
        compared += n
    return compared


def _stats_equal(ref, got):
    for f in dataclasses.fields(got):
        if f.name not in CAPTURES:
            assert getattr(got, f.name) == getattr(ref, f.name), f.name


# ---------------------------------------------------------------------------
# Against the reference engine
# ---------------------------------------------------------------------------


def _both(arch, f32):
    cfg, params, tcfg, tparams = _params(arch, f32)
    rs = RefScheduler(cfg, params, serve=_serve(cfg))
    ts = SlotScheduler(tcfg, tparams, serve=_serve(tcfg), device="cpu")
    rreqs = _requests(cfg, RefRequest)
    treqs = _requests(tcfg, Request)
    rdone = rs.run(list(rreqs))
    tdone = ts.run(list(treqs))
    return cfg, params, rs, ts, rreqs, treqs, rdone, tdone


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_stream_equals_reference(arch, f32):
    """Mixed lengths (1-token prompt included), slot reuse, a sampled
    request beside greedy ones: order and stats equal; greedy tokens
    equal wherever the reference's margin exceeds F32_MARGIN."""
    cfg, params, rs, ts, rreqs, treqs, rdone, tdone = _both(arch, True)
    assert [c.rid for c in tdone] == [c.rid for c in rdone]
    assert all(c.status == "ok" and len(c.tokens) == 5 for c in tdone)
    ref, got = rs.stats(), ts.stats()
    _stats_equal(ref, got)
    assert (ref.decode_compilations, got.decode_compilations) == (1, 0)
    assert ref.prefill_compilations == len({n for n in LENS if n > 1})
    assert got.prefill_compilations == 0
    leaves = []
    tf.tree_map(leaves.append, ts._state.cache)
    assert {t.dtype for t in leaves} == {torch.float32}
    want = {c.rid: c.tokens for c in rdone}
    got_t = {c.rid: c.tokens for c in tdone}
    n = _compare_above_margin(rreqs, got_t, want,
                              lambda s: _ref_logits(cfg, params, s),
                              F32_MARGIN)
    assert n >= 20, n


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_stream_equals_reference(arch):
    """The same stream as served, in bf16: order and stats equal; greedy
    tokens equal wherever the reference's margin exceeds BF16_MARGIN."""
    cfg, params, rs, ts, rreqs, treqs, rdone, tdone = _both(arch, False)
    assert [c.rid for c in tdone] == [c.rid for c in rdone]
    _stats_equal(rs.stats(), ts.stats())
    assert ts.stats().kv_reserved_bytes == 0      # as the reference's
    want = {c.rid: c.tokens for c in rdone}
    got_t = {c.rid: c.tokens for c in tdone}
    _compare_above_margin(rreqs, got_t, want,
                          lambda s: _ref_logits(cfg, params, s),
                          BF16_MARGIN[arch])


# ---------------------------------------------------------------------------
# Against the port's own full recompute
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stream_matches_own_recompute(arch, prec, request):
    """Greedy tokens of the port's engine against its own train-mode
    forward, teacher-forced on the served tokens, under the margin rule
    (see the module docstring for the near-tie at prompt [396])."""
    if prec == "f32":
        request.getfixturevalue("f32")
    _, _, tcfg, tparams = _params(arch, prec == "f32")
    ts = SlotScheduler(tcfg, tparams, serve=_serve(tcfg), device="cpu")
    reqs = _requests(tcfg, Request, max_new=6)
    done = {c.rid: c.tokens for c in ts.run(list(reqs))}
    margin = F32_MARGIN if prec == "f32" else BF16_MARGIN[arch]
    compared = 0
    for r in reqs:
        if r.temperature:
            continue
        seq = np.concatenate([r.tokens, done[r.rid][:-1]])
        m, top1 = _margins(_port_logits(tcfg, tparams, seq), len(r.tokens),
                           len(done[r.rid]))
        k = int(np.argmax(m < margin)) if (m < margin).any() else len(m)
        np.testing.assert_array_equal(done[r.rid][:k], top1[:k],
                                      err_msg=f"rid {r.rid}")
        compared += k
    if prec == "f32":
        assert compared >= 25, compared


# ---------------------------------------------------------------------------
# Engine contracts
# ---------------------------------------------------------------------------


class FakeGraph:
    """Stand-in for ``CudaChunkGraph``: a "capture" keeps the chunk's
    closure and a replay runs it eagerly (tests/test_torch_graphs.py)."""

    def __init__(self, fn, generators, pool):
        self.fn = fn

    def replay(self):
        return self.fn()

    def pool(self):
        return None


@pytest.mark.parametrize("arch", ARCHS)
def test_one_decode_variant_per_engine(arch):
    """Through captured variants (the stand-in), a greedy stream and then
    a mixed one: each variant the host picks is captured once, none more
    on the next pass; no prefill is captured; tokens bitwise the eager
    engine's."""
    _, _, tcfg, tparams = _params(arch)
    sv = _serve(tcfg)
    eager = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    graphed = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    graphed._graphs = gr.ChunkGraphs(graphed._slot_gen, capture=FakeGraph)
    caps = []
    for p, sampled in enumerate(((), (1, 4), (1, 4))):
        reqs = _requests(tcfg, Request, sampled=sampled, seed=p)
        a = {c.rid: c.tokens for c in eager.run(list(reqs))}
        b = {c.rid: c.tokens for c in graphed.run(list(reqs))}
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[r], b[r]) for r in a)
        caps.append(graphed.decode_compilations)
    assert caps == [1, 2, 2]
    assert {v.sampled for v in graphed._graphs.variants()} == {False, True}
    assert graphed.prefill_compilations == 0
    assert graphed._prefill_graphs is None and graphed._pf is None


@pytest.mark.parametrize("arch", ARCHS)
def test_stale_state_of_an_earlier_occupant_is_unobservable(arch):
    """One slot: a long request, then prompts of 1, 3 and 9 tokens through
    the same slot (the 1-token prompt zeroes it; the others overwrite
    every leaf, the hybrid KV's later rows staying masked) serve bitwise
    what each serves in a fresh engine."""
    _, _, tcfg, tparams = _params(arch)
    sv = _serve(tcfg, max_batch=1)
    first = _requests(tcfg, Request, lens=(40,), max_new=6, sampled=(),
                      seed=3)
    later = _requests(tcfg, Request, lens=(1, 3, 9), max_new=5, sampled=(),
                      seed=4)
    used = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    used.run(list(first))
    for r in later:
        got = used.run([r])[0].tokens
        fresh = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
        np.testing.assert_array_equal(got, fresh.run([r])[0].tokens,
                                      err_msg=f"prompt {len(r.tokens)}")


@pytest.mark.parametrize("arch", ARCHS)
def test_cancel_and_preempt(arch):
    """Cancel a running and a queued request, preempt a running one for a
    higher-priority arrival: statuses, counts and lengths as the
    reference's books keep them, every slot freed at the end."""
    _, _, tcfg, tparams = _params(arch)
    sv = _serve(tcfg)
    s = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    reqs = _requests(tcfg, Request, lens=(8, 5, 7, 4), max_new=10,
                     sampled=())
    for r in reqs:
        s.submit(r)
    s.step()
    assert s.cancel(0).status == "cancelled"            # running
    assert s.cancel(3).status == "cancelled"            # queued
    s.step()
    urgent = dataclasses.replace(
        _requests(tcfg, Request, lens=(6,), sampled=(), seed=9)[0],
        rid=7, priority=1, max_new=4)
    s.submit(urgent)
    s.step()                                           # preempts a slot
    assert s.preemptions == 1
    done = {c.rid: c for c in s.drain()}
    done.update({c.rid: c for c in s.completed})
    assert done[0].status == done[3].status == "cancelled"
    assert len(done[3].tokens) == 0
    assert all(done[r].status == "ok" for r in (1, 2, 7))
    assert len(done[1].tokens) == len(done[2].tokens) == 10
    assert len(done[7].tokens) == 4
    st = s.stats()
    assert (st.cancelled, st.preempted, st.completed) == (2, 1, 5)
    assert st.active_slots == 0 and not s.pending


@pytest.mark.parametrize("arch", ARCHS)
def test_observer_counters_equal_reference(arch, f32):
    """The same stream with a full observer on each package's engine:
    every counter (compilation counts aside), each histogram's sample
    count and the trace events (clock fields dropped) equal."""
    cfg, params, tcfg, tparams = _params(arch, True)
    obs = [m.ServeObserver(tracer=m.Tracer(sample_rate=1.0),
                           metrics_interval=0.0) for m in (robs, tobs)]
    rs = RefScheduler(cfg, params, serve=_serve(cfg), obs=obs[0])
    ts = SlotScheduler(tcfg, tparams, serve=_serve(tcfg), device="cpu",
                       obs=obs[1])
    rs.run(_requests(cfg, RefRequest))
    ts.run(_requests(tcfg, Request))
    for o, sc in zip(obs, (rs, ts)):
        o.flush(sc.stats)
    skip = {"engine." + c for c in CAPTURES}
    ref = {n: c.value for n, c in obs[0].registry.counters.items()
           if n not in skip}
    got = {n: c.value for n, c in obs[1].registry.counters.items()
           if n not in skip}
    assert got == ref and got["serve.decode_rounds"] > 0
    assert {n: h.count for n, h in obs[1].registry.hists.items()} == \
        {n: h.count for n, h in obs[0].registry.hists.items()}

    def reduced(events):
        return [(e["ph"], e["name"], e.get("cat"), e.get("id"),
                 e.get("args", {})) for e in events]

    assert reduced(obs[1].tracer.events()) == reduced(
        obs[0].tracer.events())
    assert "prefill_chunk" not in {e["name"] for e in
                                   obs[1].tracer.events()}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_serve_and_refuse_speculation(arch, capsys):
    """``ServeEngine.generate`` and ``AsyncServeEngine`` serve the
    recurrent families on the CPU (generate is the streamed path); the
    launcher prints the reference's recurrent line; speculation
    refuses."""
    _, _, tcfg, tparams = _params(arch)
    prompts = np.stack([np.arange(7, dtype=np.int32) + 5 * i
                        for i in range(3)])
    res = ServeEngine(tcfg, tparams, max_seq=32, device="cpu").generate(
        prompts, max_new=4)
    s = SlotScheduler(tcfg, tparams, serve=dataclasses.replace(
        tcfg.serve, max_batch=3, max_seq=32), device="cpu")
    done = {c.rid: c.tokens for c in s.run(
        [Request(rid=i, tokens=p, max_new=4) for i, p in enumerate(prompts)])}
    for i in range(3):
        np.testing.assert_array_equal(res.tokens[i].numpy(), done[i])
    front = AsyncServeEngine(tcfg, tparams, serve=_serve(tcfg), device="cpu")

    async def one():
        h = await front.submit(prompts[0], max_new=3)
        return [int(t) async for t in h.stream()]

    assert len(asyncio.run(one())) == 3
    with pytest.raises(ValueError, match="kv-cache family"):
        SlotScheduler(tcfg, tparams, serve=_serve(tcfg, spec_k=2),
                      device="cpu")
    launch.main(["--device", "cpu", "--arch", arch, "--requests", "4",
                 "--max-new", "3", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert f"recurrent family ({tcfg.family}): slot-scheduled state, " \
           f"prefix cache n/a" in out
    assert "statuses: {'ok': 4}" in out
    with pytest.raises(ValueError, match="kv-cache family"):
        launch.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                     "--spec-k", "2"])
