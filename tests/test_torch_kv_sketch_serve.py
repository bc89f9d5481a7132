"""Port parity: the sketched long-context engine of ``repro_torch``
against the JAX package's, on reduced gemma-2b with the reference's
parameters carried across by models/bridge.py, in the reference's own
configurations (tests/test_kv_sketch.py).

Integers must be equal: fold counts, allocator books, engine stats.
Anchors are bitwise inside the port: a window covering every context, and
a request that opts out, decode exactly as the sketch-free engine.  Floats
follow tests/test_torch_model.py: pool rows of layer 0 are bitwise equal
across the packages (embedding, one norm, one projection), so layer 0's
tail tables differ only by the order of the fold's f32 sums (within
1e-5 x max|table|); deeper layers carry the models' bf16 rounding (pool
rows within 2% of max|pool value|), so their tables are held to 2% of
max|table|.  While the two token streams agree, every greedy token
whose top-1 margin in the reference's own sketched decode exceeds
MARGIN_TOL must agree; MARGIN_TOL is twice the largest port-vs-reference
decode-logit gap measured at this size (~0.01,
tests/test_torch_serve.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.models import transformer as rtf
from repro.serve.scheduler import Request as RefRequest
from repro.serve.scheduler import SlotScheduler as RefScheduler
from repro_torch.configs.registry import reduced_config
from repro_torch.launch import serve as launch
from repro_torch.models import bridge
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Request, SlotScheduler

torch.set_num_threads(1)

MARGIN_TOL = 0.02


@pytest.fixture(scope="module")
def gemma():
    cfg, tcfg = ref_reduced("gemma-2b"), reduced_config("gemma-2b")
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return cfg, params, tcfg, tparams


def _serve(cfg, **kw):
    base = dict(max_batch=2, max_seq=128, decode_chunk=4, prefill_bucket=16)
    base.update(kw)
    return dataclasses.replace(cfg.serve, **base)


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lens]


def _run(tcfg, tparams, serve, reqs):
    sched = SlotScheduler(tcfg, tparams, serve=serve, device="cpu")
    return sched, {c.rid: list(c.tokens) for c in sched.run(reqs)}


def _books(sched):
    return (sched.alloc.peak_reserved, sched.alloc.reserved,
            sched.alloc.rc.tolist(), sorted(sched.alloc._free))


# ---------------------------------------------------------------------------
# Anchors inside the port
# ---------------------------------------------------------------------------


def test_window_covering_the_context_is_bitwise_sketch_free(gemma):
    _, _, tcfg, tparams = gemma
    reqs = lambda: [Request(rid=i, tokens=p, max_new=4)
                    for i, p in enumerate(_prompts(tcfg, [5, 21, 13, 30]))]
    s0, ref = _run(tcfg, tparams, _serve(tcfg), reqs())
    s1, got = _run(tcfg, tparams, _serve(tcfg, kv_sketch_window=128),
                   reqs())
    assert got == ref
    assert s1.fold_rows_total == 0 and _books(s1) == _books(s0)


def test_opt_out_request_stays_exact(gemma):
    _, _, tcfg, tparams = gemma
    (p,) = _prompts(tcfg, [60], seed=3)
    bs = tcfg.serve.kv_block_size
    _, got = _run(tcfg, tparams,
                  _serve(tcfg, max_batch=1, kv_sketch_window=2 * bs),
                  [Request(rid=0, tokens=p, max_new=4, kv_sketch=False)])
    _, ref = _run(tcfg, tparams, _serve(tcfg, max_batch=1),
                  [Request(rid=0, tokens=p, max_new=4)])
    assert got == ref
    # the engine facade passes the opt-out through
    eng = ServeEngine(dataclasses.replace(tcfg, serve=_serve(
        tcfg, max_batch=1, kv_sketch_window=2 * bs)), tparams, max_seq=128,
        device="cpu")
    res = eng.generate(p[None], max_new=4, kv_sketch=False)
    assert res.tokens[0].tolist() == ref[0]


def test_slot_reuse_after_sketched_retire(gemma):
    """A slot that served a folded request is clean for its next occupant:
    its tail is zeroed at admission and its frontier reset at retire."""
    _, _, tcfg, tparams = gemma
    bs = tcfg.serve.kv_block_size
    sv = _serve(tcfg, max_batch=1, max_seq=256, num_kv_blocks=24,
                kv_sketch_window=2 * bs)
    long_p, short_p = _prompts(tcfg, [150, 11], seed=5)
    sched = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    sched.run([Request(rid=0, tokens=long_p, max_new=3)])
    assert sched.fold_rows_total > 0
    assert sched._slot_first_lblk[0] == 0
    assert int(sched._state.fold_base[0]) == 0
    got = {c.rid: list(c.tokens)
           for c in sched.run([Request(rid=1, tokens=short_p, max_new=4)])}
    _, ref = _run(tcfg, tparams, sv,
                  [Request(rid=1, tokens=short_p, max_new=4)])
    assert got == ref


def test_folded_prefix_never_admitted(gemma):
    _, _, tcfg, tparams = gemma
    bs = tcfg.serve.kv_block_size
    sv = _serve(tcfg, max_batch=1, max_seq=256, num_kv_blocks=24,
                kv_sketch_window=2 * bs, admit_threshold=1)
    (p,) = _prompts(tcfg, [120], seed=8)
    sched = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    for rid in range(3):
        sched.run([Request(rid=rid, tokens=p, max_new=2)])
    assert sched.prefix_cache.stats.admitted == 0
    assert sched.alloc.reserved == 0
    # and the cache itself refuses freed blocks
    ids = sched.alloc.alloc(2)
    sched.alloc.unref(ids)
    with pytest.raises(AssertionError, match="freed block"):
        sched.prefix_cache.admit(np.arange(2 * bs, dtype=np.int32), 2 * bs,
                                 tuple(ids))


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def _reference(cfg, params, serve):
    """The reference's scheduler, made to wait for its prefill and fold
    computations.  It hands numpy block-table rows to ``jnp.asarray`` and
    then edits them in place (new blocks, fold sentinels); on the CPU
    ``jnp.asarray`` may alias the numpy buffer and dispatch is
    asynchronous, so a computation still queued can read the edited row.
    Waiting for each result before the reference's code goes on removes
    that race without changing what it computes."""
    rs = RefScheduler(cfg, params, serve=serve)
    for name in ("_prefill_chunk", "_fold_fn"):
        fn = getattr(rs, name)

        def waiting(*a, _fn=fn):
            return jax.block_until_ready(_fn(*a))

        waiting._cache_size = fn._cache_size    # read by the stats
        setattr(rs, name, waiting)
    return rs


def _ref_margins(rs, cfg, params):
    """Drive the reference scheduler (one slot) by hand and, after each
    chunk, replay its steps through the reference's own sketched
    decode_step on the post-chunk state (rows above a step's position are
    causally invisible to it; the tail and fold_base are the chunk's),
    giving the top-1 margin of every emitted token.  Returns (tokens,
    margins)."""
    toks, margins = [], []
    while rs.pending:
        rs.expire_deadlines()
        rs.admit_pending()
        cur = np.asarray(rs._state.cur)       # the chunk donates its input
        pos = np.asarray(rs._state.pos)
        if not rs.dispatch():
            break
        post = rs._state
        ct, ce = (np.asarray(a)[:, 0] for a in rs._inflight)
        sk = {"fold_base": post.fold_base, "onehot": rs.tail_onehot}
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
    assert toks == list(rs.completed[0].tokens)
    return toks, np.asarray(margins)


def test_long_context_past_pool_capacity_matches_reference(gemma):
    """A context 4x the pool's row capacity decodes because aged blocks
    fold and return to the pool; fold counts, allocator books, stats and
    the tail tables equal the reference's, and greedy tokens match it
    above the margin tolerance."""
    cfg, params, tcfg, tparams = gemma
    bs = cfg.serve.kv_block_size
    nb = 9
    kw = dict(max_batch=1, max_seq=1024, num_kv_blocks=nb,
              kv_sketch_window=4 * bs, admit_threshold=1 << 30)
    S = 4 * nb * bs + 20
    (p,) = _prompts(cfg, [S], seed=7)
    rs = _reference(cfg, params, _serve(cfg, **kw))
    rs.submit(RefRequest(rid=0, tokens=p, max_new=6))
    want, margins = _ref_margins(rs, cfg, params)
    ts, got = _run(tcfg, tparams, _serve(tcfg, **kw),
                   [Request(rid=0, tokens=p, max_new=6)])
    assert len(got[0]) == 6
    assert ts.fold_rows_total == rs.fold_rows_total > 0
    assert _books(ts) == _books(rs)
    assert ts.alloc.reserved_bytes() == 0
    rst, tst = rs.stats(), ts.stats()
    # decode_ and prefill_compilations count XLA compilations in the
    # reference and CUDA graph captures in the port, which runs eagerly on
    # the CPU
    assert (rst.decode_compilations, tst.decode_compilations) == (1, 0)
    assert (rst.prefill_compilations, tst.prefill_compilations) == (1, 0)
    for f in dataclasses.fields(tst):
        if f.name in ("decode_compilations", "prefill_compilations"):
            continue
        assert getattr(tst, f.name) == getattr(rst, f.name), f.name
    rt = bridge.tail_from_reference(
        jax.tree.map(np.asarray, rs._state.cache["tail"]), "cpu")
    tt = ts._state.cache["tail"]
    for i in range(2):
        np.testing.assert_allclose(
            tt[i, 0].numpy(), rt[i, 0].numpy(), rtol=0,
            atol=1e-5 * rt[i, 0].abs().max().item())
        np.testing.assert_allclose(
            tt[i, 1:].numpy(), rt[i, 1:].numpy(), rtol=0,
            atol=0.02 * rt[i, 1:].abs().max().item())
    # while the contexts agree, every token whose reference margin exceeds
    # the tolerance must agree; a near-tie may flip and end the comparison
    compared = 0
    for a, b, m in zip(got[0], want, margins):
        if m > MARGIN_TOL:
            assert a == b, (got[0], want, margins)
            compared += 1
        if a != b:
            break
    assert compared >= 2, (got[0], want, margins)


def test_mixed_sketched_and_exact_stream_matches_reference(gemma):
    """Sketched and opted-out requests in one engine: scheduling books
    equal the reference's, the exact request decodes as a sketch-free
    engine, everything completes."""
    cfg, params, tcfg, tparams = gemma
    bs = cfg.serve.kv_block_size
    kw = dict(max_batch=2, max_seq=256, num_kv_blocks=24,
              kv_sketch_window=2 * bs)
    pl, pe = _prompts(cfg, [140, 17], seed=9)
    rs = _reference(cfg, params, _serve(cfg, **kw))
    rdone = rs.run([RefRequest(rid=0, tokens=pl, max_new=4),
                    RefRequest(rid=1, tokens=pe, max_new=4,
                               kv_sketch=False)])
    ts, got = _run(tcfg, tparams, _serve(tcfg, **kw),
                   [Request(rid=0, tokens=pl, max_new=4),
                    Request(rid=1, tokens=pe, max_new=4, kv_sketch=False)])
    assert [c.rid for c in ts.completed] == [c.rid for c in rdone]
    assert ts.fold_rows_total == rs.fold_rows_total > 0
    assert _books(ts) == _books(rs)
    assert all(len(v) == 4 for v in got.values())
    _, ref = _run(tcfg, tparams, _serve(tcfg, max_batch=1, max_seq=256,
                                        num_kv_blocks=24),
                  [Request(rid=1, tokens=pe, max_new=4)])
    assert got[1] == ref[1]


def test_launcher_drives_the_sketched_path(capsys):
    launch.main(["--device", "cpu", "--requests", "3", "--max-new", "4",
                 "--max-seq", "256", "--kv-sketch-window", "32",
                 "--kv-sketch-rows", "2", "--long-context", "200"])
    out = capsys.readouterr().out
    assert "kv sketch: window=32" in out and "folded_rows=" in out
