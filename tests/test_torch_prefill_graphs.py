"""The prefill chunk as captured variants (serve/graphs.py,
``SlotScheduler._prefill_static``), on the CPU at reduced gemma-2b.

CUDA graphs exist only on the card (their card tests are in
tests/test_torch_cuda.py).  Here a stand-in capture records the chunk's
closure, which takes no arguments, and a replay runs it eagerly: it
reads only the static inputs the host staged for that chunk, so a
replayed stream equals the eager stream only if every chunk's tokens,
table row, offset, fold base and slot reach it through them.  What the
CPU can hold:

* a sketch-free engine captures its one prefill variant once over two
  passes of a stream whose prefix hits resume at bucket boundaries and
  inside a bucket;
* a sketched speculative engine whose prompts fold through prefill
  captures its two variants once, the draft's pool and tails written in
  the same replay as the target's;
* tokens, completion order, allocator books, pool rows and tails bitwise
  the eager engine's, and the schedule equal to the JAX reference's on
  the reference's own weights (greedy tokens above the reference's top-1
  margin, as tests/test_torch_serve.py and, for sketched prompts,
  tests/test_torch_kv_sketch_serve.py hold them);
* the decode and prefill graphs in separate pools, every capture with
  the cyclic garbage collector off, launch counts moving at replay,
  ``prefill_compilations`` 0 on the eager engine and ``graphs=True``
  refused without a card."""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.models import layers as rly
from repro.models import transformer as rtf
from repro.serve.scheduler import Request as RefRequest
from repro.serve.scheduler import SlotScheduler as RefScheduler
from repro_torch.configs.registry import reduced_config
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import bridge
from repro_torch.serve import graphs as gr
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.frontend import AsyncServeEngine
from repro_torch.serve.scheduler import Request, SlotScheduler

torch.set_num_threads(1)

MARGIN_TOL = 0.02          # tests/test_torch_serve.py's


@pytest.fixture(scope="module")
def gemma():
    cfg, tcfg = ref_reduced("gemma-2b"), reduced_config("gemma-2b")
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return cfg, params, tcfg, tparams


def _serve(cfg, **kw):
    base = dict(max_batch=3, max_seq=128, decode_chunk=4, prefill_bucket=32,
                prefix_block=16, kv_block_size=16, admit_threshold=1)
    base.update(kw)
    return dataclasses.replace(cfg.serve, **base)


class FakeGraph:
    """Stand-in for ``CudaChunkGraph``: a "capture" records the closure and
    the pool it was given, a replay calls the closure with no arguments.
    The first capture of a ``ChunkGraphs`` gets pool None and makes a new
    pool token, which that instance passes to its later captures."""

    made = []

    def __init__(self, fn, generators, pool):
        self.fn, self.given = fn, pool
        self._pool = pool if pool is not None else object()
        FakeGraph.made.append(self)

    def replay(self):
        return self.fn()

    def pool(self):
        return self._pool


def _graphed(sched):
    """Route ``sched``'s decode and prefill chunks through ``FakeGraph``
    captures; returns the list of (prefill variant, offset) per chunk."""
    sched._graphs = gr.ChunkGraphs(sched._slot_gen, capture=FakeGraph)
    sched._prefill_graphs = gr.ChunkGraphs((), capture=FakeGraph)
    chunks = []
    one = sched._prefill_one

    def spy(tok, row, off, slot=0, fold_base=0):
        chunks.append((gr.PrefillVariant(fold_base > 0), off))
        return one(tok, row, off, slot, fold_base)

    sched._prefill_one = spy
    return chunks


def _static_ptrs(sched):
    return [t.data_ptr() for t in vars(sched._pf).values()]


def _books(sched):
    return (sched.alloc.peak_reserved, sched.alloc.reserved,
            sched.alloc.rc.tolist(), sorted(sched.alloc._free))


def _ref_books(rs):
    return (rs.alloc.peak_reserved, rs.alloc.reserved, rs.alloc.rc.tolist(),
            sorted(rs.alloc._free))


def _pools_equal(a, b):
    """Pool rows [:, :NB] (both pools of a spec engine) and tails."""
    for ca, cb in zip(a._pools(), b._pools()):
        for k in ("k", "v"):
            assert torch.equal(ca["kv"][k][:, :a.num_blocks],
                               cb["kv"][k][:, :b.num_blocks]), k
        if a.sketch_on:
            assert torch.equal(ca["tail"], cb["tail"])


# ---------------------------------------------------------------------------
# A sketch-free engine: prefix hits at bucket boundaries and inside buckets
# ---------------------------------------------------------------------------


def _prefix_stream(cfg, rid0):
    """Prompts sharing one 80-token base, each admitting (threshold 1) the
    longest 16-row prefix inside the base: the hits resume at rows 32
    (a bucket boundary), 48 (inside the bucket from 32: rows 32..47
    recompute), 64 and 64 again for a prompt that is wholly a cached
    prefix (no prefill chunk at all)."""
    rng = np.random.RandomState(rid0 + 3)
    base = rng.randint(0, cfg.vocab_size, 80).astype(np.int32)
    shapes = ((40, 5), (56, 3), (70, 2), (80, 4), (64, 0))
    return [Request(rid=rid0 + i, tokens=np.concatenate(
        [base[:n], rng.randint(0, cfg.vocab_size, t).astype(np.int32)]),
        max_new=5) for i, (n, t) in enumerate(shapes)]


def test_prefill_captured_once_over_two_passes_with_prefix_hits(gemma):
    cfg, params, tcfg, tparams = gemma
    FakeGraph.made.clear()
    eager = SlotScheduler(tcfg, tparams, serve=_serve(tcfg), device="cpu")
    sched = SlotScheduler(tcfg, tparams, serve=_serve(tcfg), device="cpu")
    ptrs = _static_ptrs(sched)
    chunks = _graphed(sched)
    starts = []
    loop = sched._chunk_prefill_loop

    def spy(prompt, row, start_off, *rest):
        starts.append(start_off)
        return loop(prompt, row, start_off, *rest)

    sched._chunk_prefill_loop = spy
    want, got, caps = [], [], []
    for rid0 in (0, 100):
        want += eager.run(_prefix_stream(tcfg, rid0))
        got += sched.run(_prefix_stream(tcfg, rid0))
        caps.append(sched.prefill_compilations)
    assert [c.rid for c in got] == [c.rid for c in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.prefix_hit == b.prefix_hit
    assert _books(sched) == _books(eager)
    _pools_equal(sched, eager)

    assert starts == [0, 32, 48, 64, 64] * 2
    assert {off for _, off in chunks} == {0, 32, 64}
    assert caps == [1, 1] and eager.prefill_compilations == 0
    assert sched._prefill_graphs.variants() == [gr.PrefillVariant(False)]
    assert sched._prefill_graphs.replays == {
        gr.PrefillVariant(False): len(chunks)}
    st = sched.stats()
    assert st.prefill_compilations == 1 and st.prefix_hits == 8
    assert "compilations=1 (prefill: 1)" in st.format()
    assert _static_ptrs(sched) == ptrs

    # the schedule is the reference's, greedy tokens too above its margin
    rs = RefScheduler(cfg, params, serve=_serve(cfg))
    rdone = []
    for rid0 in (0, 100):
        rdone += rs.run([RefRequest(rid=r.rid, tokens=r.tokens,
                                    max_new=r.max_new)
                         for r in _prefix_stream(tcfg, rid0)])
    assert [c.rid for c in rdone] == [c.rid for c in got]
    assert [c.prefix_hit for c in rdone] == [c.prefix_hit for c in got]
    assert _ref_books(rs) == _books(sched)
    rst = rs.stats()
    assert (rst.prefix_hits, rst.prefix_admitted, rst.prefill_compilations) \
        == (st.prefix_hits, st.prefix_admitted, 1)
    prompts = {r.rid: r.tokens for rid0 in (0, 100)
               for r in _prefix_stream(tcfg, rid0)}
    seqs = [np.concatenate([prompts[c.rid], c.tokens]) for c in rdone]
    batch = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        batch[i, :len(s)] = s
    y, _, _ = rtf.forward(params, rtf.embed_inputs(
        params, {"tokens": jnp.asarray(batch)}, cfg), cfg, mode="train")
    lg = np.asarray(rly.logits_fn(params, y, cfg))[..., :cfg.vocab_size]
    mine = {c.rid: c.tokens for c in got}
    compared = 0
    for i, c in enumerate(rdone):
        S = len(prompts[c.rid])
        srt = np.sort(lg[i, S - 1:S - 1 + len(c.tokens)], axis=-1)
        low = srt[:, -1] - srt[:, -2] < MARGIN_TOL
        n = int(np.argmax(low)) if low.any() else len(low)
        np.testing.assert_array_equal(mine[c.rid][:n], c.tokens[:n])
        compared += n
    assert compared >= 10, compared          # not vacuous


# ---------------------------------------------------------------------------
# A sketched spec engine: fold-through prefill, the draft in lockstep
# ---------------------------------------------------------------------------


def _fold_stream(cfg, rid0):
    """A short prompt that never folds and three long ones that fold
    through prefill past a 32-row window (so their later chunks take the
    two-span variant), one of them sampled."""
    rng = np.random.RandomState(rid0 + 7)
    lens = (12, 70, 90, 55)
    return [Request(rid=rid0 + i, tokens=rng.randint(
        0, cfg.vocab_size, n).astype(np.int32), max_new=6,
        temperature=0.8 if i == 3 else 0.0, seed=rid0 + 60 + i)
        for i, n in enumerate(lens)]


def _ref_sketched_margins(cfg, params, serve, reqs):
    """The greedy requests ``reqs`` one after another through a one-slot
    plain sketched reference scheduler, driven by hand: after each chunk
    its steps are replayed through the reference's own sketched
    decode_step on the post-chunk state, as
    tests/test_torch_kv_sketch_serve.py does, giving every emitted
    token's top-1 margin.  The reference's prefill and fold computations
    are waited for, since it edits the numpy table rows they read.
    Returns {rid: (tokens, margins)}."""
    rs = RefScheduler(cfg, params, serve=serve)
    for name in ("_prefill_chunk", "_fold_fn"):
        fn = getattr(rs, name)

        def waiting(*a, _fn=fn):
            return jax.block_until_ready(_fn(*a))

        waiting._cache_size = fn._cache_size
        setattr(rs, name, waiting)
    for r in reqs:
        rs.submit(RefRequest(rid=r.rid, tokens=r.tokens, max_new=r.max_new))
    out = {r.rid: ([], []) for r in reqs}
    while rs.pending:
        rs.expire_deadlines()
        rs.admit_pending()
        cur = np.asarray(rs._state.cur)
        pos = np.asarray(rs._state.pos)
        req = rs._slot_req[0]
        if not rs.dispatch():
            break
        post = rs._state
        ct, ce = (np.asarray(a)[:, 0] for a in rs._inflight)
        sk = {"fold_base": post.fold_base, "onehot": rs.tail_onehot}
        toks, margins = out[req.rid]
        feed = cur
        for j in np.flatnonzero(ce):
            lg, _ = rtf.decode_step(params, post.cache, jnp.asarray(feed),
                                    jnp.asarray(pos + j), cfg,
                                    tables=post.tables, sketch=sk)
            srt = np.sort(np.asarray(lg)[0, :cfg.vocab_size])
            margins.append(srt[-1] - srt[-2])
            toks.append(int(ct[j]))
            feed = np.asarray([[ct[j]]], np.int32)
        rs.collect()
    for c in rs.completed:
        assert out[c.rid][0] == list(c.tokens)
    return out


def test_sketched_spec_prefill_variants_captured_once(gemma):
    cfg, params, tcfg, tparams = gemma
    kw = dict(max_seq=256, prefill_bucket=16, kv_sketch_window=32,
              admit_threshold=1 << 30, spec_k=2, draft_depth=1)
    FakeGraph.made.clear()
    eager = SlotScheduler(tcfg, tparams, serve=_serve(tcfg, **kw),
                          device="cpu")
    sched = SlotScheduler(tcfg, tparams, serve=_serve(tcfg, **kw),
                          device="cpu")
    ptrs = _static_ptrs(sched)
    chunks = _graphed(sched)
    want, got, caps = [], [], []
    for rid0 in (0, 100):
        want += eager.run(_fold_stream(tcfg, rid0))
        got += sched.run(_fold_stream(tcfg, rid0))
        caps.append(sched.prefill_compilations)
    assert [c.rid for c in got] == [c.rid for c in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert _books(sched) == _books(eager)
    assert sched.fold_rows_total == eager.fold_rows_total > 0
    _pools_equal(sched, eager)
    assert float(sched._state.cache["draft"]["tail"].abs().sum()) > 0
    assert sched.stats().spec_rounds == eager.stats().spec_rounds > 0

    used = {v for v, _ in chunks}
    assert used == {gr.PrefillVariant(False), gr.PrefillVariant(True)}
    assert caps == [2, 2]
    assert set(sched._prefill_graphs.variants()) == used
    assert sum(sched._prefill_graphs.replays.values()) == len(chunks)
    assert sched.stats().prefill_compilations == 2
    assert _static_ptrs(sched) == ptrs

    # the decode graphs and the prefill graphs each share one pool of
    # their own: never the other's
    dec = [g for g in FakeGraph.made
           if g.fn.__code__ is not FakeGraph.made[0].fn.__code__]
    pre = [g for g in FakeGraph.made if g not in dec]
    for kind in (dec, pre):
        assert kind[0].given is None
        assert all(g.given is kind[0].pool() for g in kind[1:])
    assert dec[0].pool() is not pre[0].pool()
    assert len(dec) == sched.decode_compilations
    assert len(pre) == sched.prefill_compilations

    rs = RefScheduler(cfg, params, serve=_serve(cfg, **kw))
    rdone = []
    for rid0 in (0, 100):
        rdone += rs.run([RefRequest(rid=r.rid, tokens=r.tokens,
                                    max_new=r.max_new,
                                    temperature=r.temperature, seed=r.seed)
                         for r in _fold_stream(tcfg, rid0)])
    assert [c.rid for c in rdone] == [c.rid for c in got]
    assert rs.fold_rows_total == sched.fold_rows_total
    assert _ref_books(rs) == _books(sched)

    # greedy tokens equal the reference's sketched decode above its top-1
    # margin (a greedy spec engine's tokens are the plain engine's,
    # tests/test_torch_speculative.py); a near-tie may flip and end the
    # comparison of that request
    greedy = [r for r in _fold_stream(tcfg, 0) if r.temperature == 0.0]
    ref = _ref_sketched_margins(
        cfg, params, _serve(cfg, **dict(kw, spec_k=0, max_batch=1)), greedy)
    mine = {c.rid: list(c.tokens) for c in got}
    compared = 0
    for r in greedy:
        want, margins = ref[r.rid]
        assert len(mine[r.rid]) == len(want) == r.max_new
        for a, b, m in zip(mine[r.rid], want, margins):
            if m > MARGIN_TOL:
                assert a == b, (r.rid, mine[r.rid], want, margins)
                compared += 1
            if a != b:
                break
    assert compared >= 6, compared           # not vacuous


# ---------------------------------------------------------------------------
# Launch counts, the eager engine, the CPU
# ---------------------------------------------------------------------------


def test_prefill_launch_counts_move_at_replay_not_at_capture():
    """A prefill capture runs the closure's Python once and launches
    nothing: its counts are taken back there and added at every replay,
    in a ChunkGraphs of its own beside the decode one."""
    base = paged_attention.launches

    def chunk():
        paged_attention.launches += 18       # one launch per layer
        return None

    class Recording(FakeGraph):
        def __init__(self, fn, generators, pool):
            super().__init__(fn, generators, pool)
            fn()                            # the capture runs the Python

        def replay(self):
            return None                     # the replay runs no Python

    decode = gr.ChunkGraphs([], capture=Recording)
    prefill = gr.ChunkGraphs((), capture=Recording)
    v = gr.PrefillVariant(False)
    prefill.ensure(v, chunk)
    assert paged_attention.launches == base and prefill.captures == 1
    for n in range(1, 4):
        assert prefill.replay(v) is None
        prefill.ensure(v, chunk)            # captured already: no-op
        assert paged_attention.launches == base + 18 * n
    assert prefill.replays == {v: 3} and decode.captures == 0
    assert [p.name for p in (gr.PrefillVariant(False),
                             gr.PrefillVariant(True))] == [
        "prefill", "prefill+sketched"]
    paged_attention.launches = base


def test_capture_runs_with_the_cyclic_gc_off():
    """Destroying a CUDA graph is forbidden while another is captured, and
    a discarded engine in a reference cycle is destroyed whenever the
    cyclic collector runs: every capture, decode or prefill, runs with
    the collector off, and the caller's setting is restored after."""
    seen = []

    class Probe(FakeGraph):
        def __init__(self, fn, generators, pool):
            super().__init__(fn, generators, pool)
            seen.append(gc.isenabled())

    enabled = gc.isenabled()
    try:
        for on in (True, False):
            (gc.enable if on else gc.disable)()
            for g, v in ((gr.ChunkGraphs([], capture=Probe),
                          gr.Variant(False, False)),
                         (gr.ChunkGraphs((), capture=Probe),
                          gr.PrefillVariant(True))):
                g.ensure(v, lambda: None)
                assert gc.isenabled() == on
    finally:
        (gc.enable if enabled else gc.disable)()
    assert seen == [False] * 4


def test_eager_engine_counts_no_prefill_captures(gemma):
    """The CPU's engines run prefill eagerly (``prefill_compilations``
    0, no prefill graphs); ``graphs=True`` is refused without a card."""
    _, _, tcfg, tparams = gemma
    sv = _serve(tcfg)
    for graphs in (None, False):
        sched = SlotScheduler(tcfg, tparams, serve=sv, device="cpu",
                              graphs=graphs)
        assert sched._prefill_graphs is None
        sched.run(_prefix_stream(tcfg, 0)[:2])
        assert sched.prefill_compilations == 0
        assert sched.stats().prefill_compilations == 0
        assert len(sched.prefill_chunk_ms()) == 0   # timed on the card
        eng = ServeEngine(tcfg, tparams, max_seq=64, device="cpu",
                          graphs=graphs)
        eng.generate(np.ones((2, 5), np.int32), max_new=3)
        assert eng.prefill_compilations == 0
        assert "(prefill: 0)" in eng.stats().format()
    with pytest.raises(ValueError, match="CUDA"):
        SlotScheduler(tcfg, tparams, serve=sv, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        AsyncServeEngine(tcfg, tparams, serve=sv, device="cpu", graphs=True)
