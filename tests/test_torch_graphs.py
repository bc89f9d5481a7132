"""The decode chunk as captured variants (serve/graphs.py) and the
sampler that makes it capturable, on the CPU at reduced gemma-2b.

The chunk runs eagerly here (CUDA graphs exist only on the card; their
card tests are in tests/test_torch_cuda.py).  What the CPU can hold:

* the all-slot sampler: greedy slots bitwise the argmax-only chunk's
  whatever their neighbours sample, and a caller's generator giving the
  tokens of its seed and ending in the state the old per-slot draw (one
  Exp(1) draw of the vocabulary per decode step while the slot held the
  request) left it in;
* the variant the host picks per dispatch, over a mixed greedy / sampled
  / folding stream and a speculative one, with a stand-in capture that
  replays the eager chunk: each variant captured once over two passes,
  tokens bitwise the eager engine's, and the schedule (completion order,
  allocator books, fold rows) equal to the JAX reference's on the
  reference's own weights;
* launch counts moving at replay, not at capture;
* ``graphs=True`` refused without a card.

Every comparison here is bitwise (tokens, books, generator states)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
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


@pytest.fixture(scope="module")
def gemma():
    cfg, tcfg = ref_reduced("gemma-2b"), reduced_config("gemma-2b")
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return cfg, params, tcfg, tparams


def _serve(cfg, **kw):
    base = dict(max_batch=3, max_seq=128, decode_chunk=4, prefill_bucket=16,
                prefix_block=16, kv_block_size=16)
    base.update(kw)
    return dataclasses.replace(cfg.serve, **base)


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _books(sched):
    return (sched.alloc.peak_reserved, sched.alloc.reserved,
            sched.alloc.rc.tolist(), sorted(sched.alloc._free))


class FakeGraph:
    """Stand-in for ``CudaChunkGraph``: a "capture" records the chunk's
    closure and a replay runs it eagerly, so a replayed stream is the
    eager stream and the test sees which variants were captured."""

    made = []

    def __init__(self, fn, generators, pool):
        self.fn = fn
        FakeGraph.made.append(self)

    def replay(self):
        return self.fn()

    def pool(self):
        return None


def _graphed(sched):
    """Route ``sched``'s dispatches through captured variants made by
    ``FakeGraph``, and record the variant each dispatch picked."""
    sched._graphs = gr.ChunkGraphs(sched._slot_gen, capture=FakeGraph)
    picked = []
    pick = sched._variant

    def spy(fold):
        v = pick(fold)
        picked.append(v)
        return v

    sched._variant = spy
    return picked


# ---------------------------------------------------------------------------
# The all-slot sampler
# ---------------------------------------------------------------------------


def test_greedy_slots_are_independent_of_sampled_neighbours(gemma):
    """Greedy requests in slots 0 and 2 beside a sampled request in slot 1
    (every chunk the sampling variant) emit the tokens they emit beside a
    greedy neighbour (every chunk the argmax-only variant), bitwise."""
    _, _, tcfg, tparams = gemma
    p = _prompts(tcfg, (9, 14, 21), seed=3)
    greedy = [Request(rid=i, tokens=p[i], max_new=7) for i in range(3)]
    mixed = list(greedy)
    mixed[1] = Request(rid=1, tokens=p[1], max_new=7, temperature=1.3,
                       top_k=0, seed=11)
    got = {}
    for name, reqs in (("greedy", greedy), ("mixed", mixed)):
        sched = SlotScheduler(tcfg, tparams, serve=_serve(tcfg),
                              device="cpu")
        picked = _graphed(sched)
        got[name] = {c.rid: c.tokens for c in sched.run(list(reqs))}
        assert {v.sampled for v in picked} == {name == "mixed"}
    for rid in (0, 2):
        np.testing.assert_array_equal(got["mixed"][rid], got["greedy"][rid])


def test_caller_generator_draws_as_its_seed_and_ends_as_old_draws(gemma):
    """A sampled request with ``generator=g`` (g seeded with s) emits the
    tokens of ``seed=s``; afterwards g stands where the old per-slot draw
    left it: one Exp(1) draw over the vocabulary per decode step of every
    chunk dispatched while the slot held the request.  A greedy request's
    generator is never touched."""
    _, _, tcfg, tparams = gemma
    (p,) = _prompts(tcfg, (12,), seed=5)
    sv = _serve(tcfg)

    def run(**kw):
        sched = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
        (c,) = sched.run([Request(rid=0, tokens=p, max_new=9,
                                  temperature=0.9, top_k=5, **kw)])
        return c.tokens, sched.decode_steps

    g = torch.Generator().manual_seed(1234)
    by_gen, steps = run(generator=g)
    by_seed, _ = run(seed=1234)
    np.testing.assert_array_equal(by_gen, by_seed)
    old = torch.Generator().manual_seed(1234)
    for _ in range(steps):
        torch.empty((tcfg.vocab_size,)).exponential_(generator=old)
    assert steps == 12 and torch.equal(g.get_state(), old.get_state())
    # a different seed draws different tokens (the seed reaches the slot)
    other, _ = run(seed=1235)
    assert not np.array_equal(other, by_seed)

    h = torch.Generator().manual_seed(99)
    before = h.get_state()
    sched = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    sched.run([Request(rid=0, tokens=p, max_new=3, generator=h)])
    assert torch.equal(h.get_state(), before)


def test_preempted_sampled_request_resumes_its_draws(gemma):
    """A sampled request preempted mid-stream by a higher-priority one
    and resumed emits the tokens it emits uncontended (one slot, so the
    continuation draws on from the slot generator's state), and its
    caller's generator ends where the uncontended run leaves it."""
    _, _, tcfg, tparams = gemma
    p = _prompts(tcfg, (10, 8), seed=6)
    sv = _serve(tcfg, max_batch=1, preemption=True)

    def low(g):
        return Request(rid=0, tokens=p[0], max_new=10, temperature=0.8,
                       top_k=0, generator=g)

    g_alone = torch.Generator().manual_seed(77)
    alone = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    want = alone.run([low(g_alone)])[0].tokens

    g = torch.Generator().manual_seed(77)
    sched = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    sched.submit(low(g))
    sched.step()                          # one chunk of the low request
    sched.submit(Request(rid=1, tokens=p[1], max_new=3, priority=1))
    done = {c.rid: c for c in sched.drain()}
    assert sched.preemptions == 1
    np.testing.assert_array_equal(done[0].tokens, want)
    # both runs drew for 12 steps: 3 chunks uncontended, 1 + 2 preempted
    assert torch.equal(g.get_state(), g_alone.get_state())


# ---------------------------------------------------------------------------
# Variants, captures, launch counts
# ---------------------------------------------------------------------------


def _mixed_stream(cfg, rid0=0):
    """Four groups, each drained before the next: greedy short prompts,
    a sampled short one, greedy prompts long enough to fold past a 32-row
    window, and a sampled long one beside a greedy short one — one group
    for each variant."""
    groups = (((12, 0.0), (20, 0.0)), ((14, 0.7),), ((70, 0.0), (90, 0.0)),
              ((55, 0.9), (12, 0.0)))
    out, rid = [], rid0
    for g in groups:
        p = _prompts(cfg, [n for n, _ in g], seed=rid)
        out.append([Request(rid=rid + i, tokens=p[i], max_new=6,
                            temperature=t, top_k=4, seed=rid + 40 + i)
                    for i, (_, t) in enumerate(g)])
        rid += len(g)
    return out


def _run_groups(sched, groups):
    return [c for g in groups for c in sched.run(g)]


def test_variant_per_dispatch_one_capture_each_over_two_passes(gemma):
    """Over two passes of a mixed greedy / sampled / folding stream on a
    sketched engine: every dispatch picks the variant its live slots call
    for, each variant is captured once (the second pass captures nothing),
    ``decode_compilations`` counts the variants, and tokens, completion
    order and allocator books are the eager engine's bitwise; the
    schedule and fold rows are the JAX reference's."""
    cfg, params, tcfg, tparams = gemma
    kw = dict(max_seq=256, kv_sketch_window=32, admit_threshold=1 << 30)
    FakeGraph.made.clear()
    eager = SlotScheduler(tcfg, tparams, serve=_serve(tcfg, **kw),
                          device="cpu")
    sched = SlotScheduler(tcfg, tparams, serve=_serve(tcfg, **kw),
                          device="cpu")
    picked = _graphed(sched)
    want, got, counts = [], [], []
    for rid0 in (0, 10):
        want += _run_groups(eager, _mixed_stream(tcfg, rid0))
        got += _run_groups(sched, _mixed_stream(tcfg, rid0))
        counts.append(sched.decode_compilations)
    assert [c.rid for c in got] == [c.rid for c in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert _books(sched) == _books(eager)
    assert sched.fold_rows_total == eager.fold_rows_total > 0

    used = set(picked)
    assert used == {gr.Variant(s, k) for s in (False, True)
                    for k in (False, True)}
    assert counts == [len(used), len(used)] and len(FakeGraph.made) == 4
    assert set(sched._graphs.variants()) == used
    assert sum(sched._graphs.replays.values()) == len(picked)
    assert sched.stats().decode_compilations == 4
    assert "compilations=4" in sched.stats().format()
    assert eager.decode_compilations == 0

    rs = RefScheduler(cfg, params, serve=_serve(cfg, **kw))
    rdone = []
    for rid0 in (0, 10):
        for g in _mixed_stream(tcfg, rid0):
            rdone += rs.run([RefRequest(rid=r.rid, tokens=r.tokens,
                                        max_new=r.max_new) for r in g])
    # the schedule does not depend on sampling
    assert [c.rid for c in rdone] == [c.rid for c in got]
    assert rs.fold_rows_total == sched.fold_rows_total
    assert (rs.alloc.peak_reserved, rs.alloc.reserved) == \
        _books(sched)[:2]


def test_variant_follows_the_live_slots(gemma):
    """Each dispatch's variant is (some live slot samples, some live slot
    attends a folded tail after the dispatch's fold), read from the host
    mirrors just before the chunk."""
    _, _, tcfg, tparams = gemma
    sched = SlotScheduler(tcfg, tparams, serve=_serve(
        tcfg, max_seq=256, kv_sketch_window=32, admit_threshold=1 << 30),
        device="cpu")
    picked = _graphed(sched)
    plan = sched._plan_folds
    seen = []

    def spy():
        fold = plan()
        live = [s for s, r in enumerate(sched._slot_req) if r is not None]
        want = gr.Variant(
            any(sched._slot_req[s].temperature > 0 for s in live),
            any(sched._slot_first_lblk[s] * sched.block_size + fold[s] > 0
                for s in live))
        seen.append(want)
        return fold

    sched._plan_folds = spy
    _run_groups(sched, _mixed_stream(tcfg))
    assert seen == picked
    assert {v.sketched for v in picked} == {False, True}
    assert {v.sampled for v in picked} == {False, True}


def test_speculative_engine_variants_and_tokens(gemma):
    """A spec engine's chunk (spec_k 2, depth-1 draft) as captured
    variants: greedy and sampled chunks, one capture each over two passes,
    tokens bitwise the eager spec engine's, and greedy tokens bitwise the
    plain engine's."""
    _, _, tcfg, tparams = gemma
    sv = _serve(tcfg, spec_k=2, draft_depth=1, max_seq=96)
    p = _prompts(tcfg, (9, 17, 12, 25), seed=8)
    reqs = lambda rid0: [Request(rid=rid0 + i, tokens=p[i], max_new=6,
                                 temperature=0.8 if i == 1 else 0.0,
                                 seed=rid0 + i) for i in range(4)]
    eager = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    sched = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    picked = _graphed(sched)
    plain = SlotScheduler(tcfg, tparams, serve=_serve(tcfg, max_seq=96),
                          device="cpu")
    for rid0 in (0, 10):
        want = {c.rid: c.tokens for c in eager.run(reqs(rid0))}
        got = {c.rid: c.tokens for c in sched.run(reqs(rid0))}
        base = {c.rid: c.tokens for c in plain.run(reqs(rid0))}
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])
            if rid % 10 != 1:
                np.testing.assert_array_equal(got[rid], base[rid])
    assert {v for v in picked} == {gr.Variant(False, False),
                                  gr.Variant(True, False)}
    assert sched.decode_compilations == 2
    assert sched.stats().spec_rounds == eager.stats().spec_rounds > 0


def test_launch_counts_move_at_replay_not_at_capture():
    """A capture runs the chunk's Python once and launches nothing: the
    counters it moved are taken back and added again at every replay."""
    base = paged_attention.launches

    def chunk():
        paged_attention.launches += 3        # a wrapper's count of launches
        return torch.zeros(1)

    class Recording(FakeGraph):
        def __init__(self, fn, generators, pool):
            super().__init__(fn, generators, pool)
            fn()                            # the capture runs the Python

        def replay(self):
            return torch.zeros(1)           # the replay runs no Python

    g = gr.ChunkGraphs([], capture=Recording)
    v = gr.Variant(False, False)
    g.ensure(v, chunk)
    assert paged_attention.launches == base and g.captures == 1
    for n in range(1, 4):
        g.replay(v)
        g.ensure(v, chunk)                  # captured already: no-op
        assert paged_attention.launches == base + 3 * n
    assert g.captures == 1 and g.replays == {v: 3}
    paged_attention.launches = base


def test_graphs_on_the_cpu_are_refused(gemma):
    _, _, tcfg, tparams = gemma
    sv = _serve(tcfg)
    with pytest.raises(ValueError, match="CUDA"):
        SlotScheduler(tcfg, tparams, serve=sv, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        AsyncServeEngine(tcfg, tparams, serve=sv, device="cpu", graphs=True)
    eng = ServeEngine(tcfg, tparams, max_seq=64, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        eng.generate(np.zeros((1, 4), np.int32), max_new=2)
    # None and False run the eager chunk here
    for graphs in (None, False):
        eng = ServeEngine(tcfg, tparams, max_seq=64, device="cpu",
                          graphs=graphs)
        eng.generate(np.ones((2, 5), np.int32), max_new=3)
        assert eng.decode_compilations == 0
