"""Port parity: speculative decoding, the count-sketch-compressed draft and
the FCS-sketched LM head of ``repro_torch`` against the JAX package, on
reduced gemma-2b with the reference's parameters carried across by
models/bridge.py.

Tolerances.  Integers are equal: hash buckets and signs, leaf seeds,
allocator books, completion order, speculative counters.  Inside the
port the speculative contract is bitwise: verify logits and pool rows
equal sequential decode steps', and greedy speculative tokens equal plain
greedy tokens.  Against the reference:
  * reconstructed draft weights and the sketched head: one bf16 rounding
    (2^-8 relative) of the largest entry of the leaf, since the two
    packages sum the same f32 count sketch in different orders before the
    bf16 cast;
  * logits: ``MARGIN_TOL`` (0.02), twice the largest decode-logit gap
    between the packages at this size (tests/test_torch_serve.py), and
    greedy tokens compared while the reference's top-1 margin exceeds it.
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.launch.serve import make_request_stream as ref_stream
from repro.models import draft as rdr
from repro.models import layers as rly
from repro.models import transformer as rtf
from repro.serve.scheduler import SlotScheduler as RefScheduler
from repro.sketch import hashing as rhashing
from repro_torch.configs.registry import reduced_config
from repro_torch.launch import serve as launch
from repro_torch.launch.serve import make_request_stream
from repro_torch.models import bridge
from repro_torch.models import draft as dr
from repro_torch.models import layers as ly
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.frontend import AsyncServeEngine
from repro_torch.serve.scheduler import Request, SlotScheduler
from repro_torch.serve.speculative import round_accounting
from repro_torch.sketch import hashing

torch.set_num_threads(1)

MARGIN_TOL = 0.02
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def gemma():
    cfg, tcfg = ref_reduced("gemma-2b"), reduced_config("gemma-2b")
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return cfg, params, tcfg, tparams


def _serve(cfg, **kw):
    base = dict(max_batch=2, max_seq=96, decode_chunk=4, prefill_bucket=16,
                prefix_block=16, kv_block_size=16, admit_threshold=100)
    base.update(kw)
    return dataclasses.replace(cfg.serve, **base)


def _requests(cfg, seed, lens, max_new=5, **kw):
    rng = np.random.RandomState(seed)
    return [Request(rid=i, tokens=rng.randint(0, cfg.vocab_size, (n,)
                                              ).astype(np.int32),
                    max_new=max_new, **kw)
            for i, n in enumerate(lens)]


def _run(tcfg, tparams, serve, reqs, **kw):
    sched = SlotScheduler(tcfg, tparams, serve=serve, device="cpu", **kw)
    return sched, {c.rid: list(c.tokens) for c in sched.run(list(reqs))}


def _books(sched):
    return (sched.alloc.peak_reserved, sched.alloc.reserved,
            sched.alloc.rc.tolist(), sorted(sched.alloc._free))


# ---------------------------------------------------------------------------
# Draft derivation
# ---------------------------------------------------------------------------


def test_truncate_params_bitwise(gemma):
    cfg, params, tcfg, tparams = gemma
    rp, rcfg = rdr.truncate_params(params, cfg, 1)
    tp, dcfg = dr.truncate_params(tparams, tcfg, 1)
    assert dcfg.num_layers == rcfg.num_layers == 1
    assert len(tp["blocks"]) == 1
    got = bridge.from_reference(jax.tree.map(np.asarray, rp), dcfg,
                                device="cpu")
    for (name, a), (_, b) in zip(tf.param_leaves(got), tf.param_leaves(tp)):
        for x, y in zip(a, b):
            assert torch.equal(x, y), name
    # embed, head and final norm are shared, not copied
    assert tp["embed"] is tparams["embed"]
    assert tp["blocks"][0] is tparams["blocks"][0]
    with pytest.raises(ValueError):
        dr.truncate_params(tparams, tcfg, tcfg.num_layers + 1)


def _recorded_seeds(monkeypatch, module, run):
    """(d_in, d_out, ratio, rows, seed) of every ``_cs_reconstruct`` call
    that ``run()`` makes through ``module``, in order."""
    calls = []
    real = module._cs_reconstruct

    def spy(w, ratio, rows, seed):
        calls.append((int(w.shape[0]), int(w.shape[1]), ratio, rows, seed))
        return real(w, ratio, rows, seed)

    monkeypatch.setattr(module, "_cs_reconstruct", spy)
    out = run()
    monkeypatch.setattr(module, "_cs_reconstruct", real)
    return calls, out


def test_compressed_leaf_names_seeds_and_hashes_equal_reference(
        gemma, monkeypatch):
    """The port compresses the reference's leaves (same names, same
    flatten order), each layer under the reference's seed, and hashes
    the contraction dim into the reference's buckets and signs."""
    cfg, params, tcfg, tparams = gemma
    ref_names = ["/".join(str(getattr(k, "key", k)) for k in path)
                 for path, leaf in jax.tree_util.tree_flatten_with_path(
                     params["blocks"])[0] if leaf.ndim == 3]
    assert [n for n, _ in dr.block_matrices(tparams["blocks"][0])] == \
        ref_names
    rcalls, _ = _recorded_seeds(
        monkeypatch, rdr, lambda: rdr.compress_params(params, cfg, 2, 2))
    tcalls, _ = _recorded_seeds(
        monkeypatch, dr, lambda: dr.compress_params(tparams, tcfg, 2, 2))
    # the reference walks leaf by leaf over layers, the port layer by
    # layer over leaves: the same set of (shape, seed) calls
    assert sorted(tcalls) == sorted(rcalls) and len(set(tcalls)) == \
        len(tcalls)
    for d_in, _, ratio, rows, seed in tcalls:
        J = d_in // ratio
        rb, rs = rhashing.row_buckets_signs(
            rhashing.cached_coeffs(seed, rows),
            jnp.arange(d_in, dtype=jnp.int32), J, signed=True)
        tb, ts = hashing.row_buckets_signs(
            hashing.cached_coeffs(seed, rows), torch.arange(d_in), J,
            signed=True)
        np.testing.assert_array_equal(np.asarray(rb), tb.numpy())
        np.testing.assert_array_equal(np.asarray(rs), ts.numpy())


def test_compressed_weights_and_sketched_head_match_reference(gemma):
    """Reconstructed matrices and the sketched head within one bf16
    rounding of the leaf's largest entry; norms pass through bitwise."""
    cfg, params, tcfg, tparams = gemma
    rp, rcfg = rdr.compress_params(params, cfg, 2, ratio=2)
    tp, dcfg = dr.compress_params(tparams, tcfg, 2, ratio=2)
    assert dcfg.sketch.sketched_head and not dcfg.tie_embeddings
    assert dcfg.sketch.head_hash_len == rcfg.sketch.head_hash_len == \
        tcfg.d_model // 2
    want = bridge.from_reference(jax.tree.map(np.asarray, rp), dcfg,
                                 device="cpu")
    for (name, a), (_, b) in zip(tf.param_leaves(want),
                                 tf.param_leaves(tp)):
        for x, y in zip(a, b):
            x, y = x.float(), y.float()
            if x.ndim < 2:
                assert torch.equal(x, y), name
                continue
            tol = BF16_ULP * x.abs().max().item()
            assert (x - y).abs().max().item() <= tol, name
            # and the reconstruction differs from the dense weight
    assert not torch.equal(tp["blocks"][0]["attn"]["wq"],
                           tparams["blocks"][0]["attn"]["wq"])
    # ratio <= 1 is pure truncation
    tp0, dcfg0 = dr.compress_params(tparams, tcfg, 2, ratio=0)
    assert not dcfg0.sketch.sketched_head
    assert tp0["blocks"][1]["ffn"]["w_up"] is \
        tparams["blocks"][1]["ffn"]["w_up"]


def test_sketched_head_hash_and_logits_match_reference(gemma):
    cfg, params, tcfg, tparams = gemma
    rp, rcfg = rdr.compress_params(params, cfg, 1, ratio=2)
    tp, dcfg = dr.compress_params(tparams, tcfg, 1, ratio=2)
    J = dcfg.sketch.head_hash_len
    h, sg = ly._head_hash_tables(dcfg.sketch.seed, tcfg.d_model, J)
    rh, rsg = rly._head_hash_tables(rcfg.sketch.seed, cfg.d_model, J)
    np.testing.assert_array_equal(h, rh)
    np.testing.assert_array_equal(sg, rsg)
    x = np.random.RandomState(3).randn(3, 5, tcfg.d_model).astype(np.float32)
    xr = jnp.asarray(x, jnp.bfloat16)
    xt = torch.as_tensor(x).to(torch.bfloat16)
    want = np.asarray(rly.logits_fn(rp, xr, rcfg))
    got = ly.logits_fn(tp, xt, dcfg).numpy()
    assert np.abs(got - want).max() <= MARGIN_TOL, np.abs(got - want).max()


def test_sketched_head_trains_like_reference(gemma):
    """A model built with the sketched head: init shape, and the training
    loss and its head gradient against the reference's (the activation
    sketch's backward is the signed lookup)."""
    cfg, _, tcfg, _ = gemma
    sk = dict(sketched_head=True, head_hash_len=16)
    rcfg = dataclasses.replace(cfg, sketch=dataclasses.replace(cfg.sketch,
                                                               **sk))
    scfg = dataclasses.replace(tcfg, sketch=dataclasses.replace(tcfg.sketch,
                                                                **sk))
    assert tf.init_params(scfg, device="cpu")["head"].shape == \
        (16, scfg.padded_vocab)
    params = rtf.init_params(jax.random.PRNGKey(1), rcfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), scfg,
                                    device="cpu")
    rng = np.random.RandomState(2)
    toks = rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rloss, rgrad = jax.value_and_grad(
        lambda p: rtf.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, rcfg))(params)
    for p in tf.param_leaves(tparams):
        for t in p[1]:
            t.requires_grad_(True)
    loss = tf.loss_fn(tparams, {k: torch.as_tensor(v).long()
                                for k, v in batch.items()}, scfg)
    loss.backward()
    assert abs(loss.item() - float(rloss)) <= 1e-2 * abs(float(rloss))
    for name, ref_g, got_g in (
            ("head", rgrad["head"], tparams["head"].grad),
            ("wq", rgrad["blocks"]["attn"]["wq"][0],
             tparams["blocks"][0]["attn"]["wq"].grad)):
        rg = np.asarray(jnp.asarray(ref_g, jnp.float32))
        tg = got_g.float().numpy()
        assert np.abs(tg - rg).max() <= 0.05 * np.abs(rg).max(), name


def test_make_draft_gating(gemma):
    _, _, tcfg, tparams = gemma
    assert dr.make_draft(tparams, tcfg, _serve(tcfg, spec_k=0)) is None
    d = dr.make_draft(tparams, tcfg, _serve(tcfg, spec_k=2, draft_depth=1))
    assert d is not None and d.cfg.num_layers == 1
    d = dr.make_draft(tparams, tcfg, _serve(tcfg, spec_k=2, draft_depth=9))
    assert d.cfg.num_layers == tcfg.num_layers
    ssm = dataclasses.replace(tcfg, family="ssm")
    assert dr.make_draft(tparams, ssm, _serve(ssm, spec_k=2)) is None
    with pytest.raises(ValueError, match="kv-cache family"):
        SlotScheduler(ssm, tparams, serve=_serve(ssm, spec_k=2),
                      device="cpu")


# ---------------------------------------------------------------------------
# verify_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pos0", [(3, 1), (44, 40)])
def test_verify_step_bitwise_sequential_decode(gemma, pos0):
    """Verify logits at position index + i are bitwise a decode step's
    after committing the first i + 1 tokens, both at the engine's padded
    row count, and the pool rows equal; the second case runs past the 48
    rows of each slot's table, whose rows land in the write sink.
    Against the reference's verify_step within MARGIN_TOL."""
    cfg, params, tcfg, tparams = gemma
    B, bs, nbs, C = 2, 8, 6, 5
    NB = B * nbs
    rng = np.random.RandomState(5)
    toks = rng.randint(0, cfg.vocab_size, (B, C)).astype(np.int64)
    tables = torch.arange(NB, dtype=torch.int32).reshape(B, nbs)
    pos = torch.tensor(pos0, dtype=torch.int32)
    cache_v = tf.init_paged_cache(tcfg, NB, bs, device="cpu")
    rows = ly.padded_rows(B)
    lg_v, _ = tf.verify_step(tparams, cache_v, torch.as_tensor(toks), pos,
                             tcfg, tables, rows=rows)
    assert lg_v.shape == (B, C, tcfg.padded_vocab)
    cache_d = tf.init_paged_cache(tcfg, NB, bs, device="cpu")
    for i in range(C):
        lg_d, _ = tf.decode_step(tparams, cache_d,
                                 torch.as_tensor(toks[:, i:i + 1]), pos + i,
                                 tcfg, tables, rows=rows)
        assert torch.equal(lg_v[:, i], lg_d), f"offset {i}"
    for k in ("k", "v"):
        assert torch.equal(cache_v["kv"][k], cache_d["kv"][k])
    ref_v, _ = rtf.verify_step(params, rtf.init_paged_cache(cfg, NB, bs),
                               jnp.asarray(toks, jnp.int32),
                               jnp.asarray(pos0, jnp.int32), cfg,
                               tables=jnp.asarray(tables.numpy()))
    diff = np.abs(np.asarray(ref_v) - lg_v.numpy())[..., :cfg.vocab_size]
    assert diff.max() <= MARGIN_TOL, diff.max()


# ---------------------------------------------------------------------------
# Greedy identity inside the port
# ---------------------------------------------------------------------------


def _mixed(cfg):
    rng = np.random.RandomState(7)
    t = lambda n: rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
    return [Request(rid=0, tokens=t(12), max_new=5),           # speculates
            Request(rid=1, tokens=t(7), max_new=5, spec_k=0),  # plain
            Request(rid=2, tokens=t(9), max_new=5, temperature=0.8, top_k=4,
                    seed=3),                                    # sampled
            Request(rid=3, tokens=t(19), max_new=5, spec_k=2)]  # clamped


# name: (serve knobs of the spec engine, requests from (cfg) -> list)
IDENTITY_CASES = {
    "k1_depth1": (dict(spec_k=1, draft_depth=1),
                  lambda c: _requests(c, 6, [5, 16, 9, 23])),
    "k3_depth1": (dict(spec_k=3, draft_depth=1),
                  lambda c: _requests(c, 6, [5, 16, 9, 23])),
    "k3_depth2_ratio2": (dict(spec_k=3, draft_depth=2, draft_sketch_ratio=2),
                         lambda c: _requests(c, 6, [5, 16, 9, 23])),
    "mixed_batch": (dict(spec_k=3, draft_depth=1, max_batch=3), _mixed),
    "budget_clip": (dict(spec_k=6, draft_depth=2),
                    lambda c: _requests(c, 8, [10, 6], max_new=3)),
}


@pytest.mark.parametrize("case", sorted(IDENTITY_CASES))
def test_greedy_spec_equals_plain(gemma, case):
    """Greedy speculative tokens are bitwise plain greedy tokens for any
    spec_k and draft (truncated or count-sketch-compressed), in mixed
    spec / plain / sampled batches and when a budget clips a round; no
    block leaks."""
    _, _, tcfg, tparams = gemma
    kw, make = IDENTITY_CASES[case]
    reqs = make(tcfg)
    plain_kw = {k: v for k, v in kw.items() if k == "max_batch"}
    _, ref = _run(tcfg, tparams, _serve(tcfg, **plain_kw), reqs)
    sched, got = _run(tcfg, tparams, _serve(tcfg, **kw), reqs)
    for r in reqs:
        assert len(got[r.rid]) == r.max_new
        assert all(0 <= t < tcfg.vocab_size for t in got[r.rid])
        if not r.temperature:
            assert got[r.rid] == ref[r.rid], f"rid {r.rid}"
    assert sched.alloc.reserved == sched.prefix_cache.held_blocks()
    assert sched.stats().spec_rounds > 0


# name: (serve knobs, whether a verify step runs past the decode step's
# rows).  Decode steps pad their rows to padded_rows(max_batch) (64
# here); a verify step's max_batch * (spec_k + 1) rows past that run in
# slabs of it.  Reduced gemma-2b has 4 query heads a kv head, so a
# sketched engine's tail span holds 4 * (spec_k + 1) verify rows a slot,
# in slabs of padded_rows(4).
ROW_LIMIT_CASES = {
    "verify_rows_at_the_tile": (dict(max_batch=16, spec_k=3), False),
    "verify_rows_past_the_tile": (dict(max_batch=16, spec_k=4), True),
    "plain_past_the_tile": (dict(max_batch=72), False),
    "tail_rows_at_the_tile": (dict(spec_k=15, kv_sketch_window=16), False),
    "tail_rows_past_the_tile": (dict(spec_k=16, kv_sketch_window=16), True),
    "unsketched_k16": (dict(spec_k=16), False),
    "batch8_k8": (dict(max_batch=8, spec_k=8), True),
    "batch8_k16": (dict(max_batch=8, spec_k=16), True),
}


def _exact(cfg, params):
    """The port's params with every layer above the first adding nothing
    to the residual stream: a depth-1 draft is the target bitwise."""
    blocks = [blk if i == 0 else
              {**blk, "attn": {**blk["attn"],
                               "wo": torch.zeros_like(blk["attn"]["wo"])},
               "ffn": {**blk["ffn"],
                       "w_down": torch.zeros_like(blk["ffn"]["w_down"])}}
              for i, blk in enumerate(params["blocks"])]
    return {**params, "blocks": blocks}


@pytest.mark.parametrize("case", sorted(ROW_LIMIT_CASES))
def test_spec_engine_refuses_verify_rows_past_the_decode_rows(gemma, case):
    """No spec_k is refused: the engine builds at the plain engine's step
    rows, and where its verify rows (max_batch * (spec_k + 1)), or its
    sketched tail-span rows, pad past them, it serves greedy tokens
    bitwise the plain engine's, each row op running in slabs of the
    decode step's shape (models/layers.py, row padding).  The sketched
    case serves prompts that fold, through an exact draft that accepts
    every proposal its budget leaves room for, with each request's budget
    inside one round,
    so that both engines fold at the same chunk head (ROADMAP Queue 1
    #22: an accepted proposal moves later chunk heads)."""
    _, _, tcfg, tparams = gemma
    kw, past = ROW_LIMIT_CASES[case]
    sv = _serve(tcfg, **kw)
    sched = SlotScheduler(tcfg, tparams, serve=sv, device="cpu")
    assert sched.step_rows == ly.padded_rows(sv.max_batch)
    if not past:
        return
    sketched = bool(sv.kv_sketch_window)
    params = _exact(tcfg, tparams) if sketched else tparams
    rows = (tcfg.num_heads // tcfg.num_kv_heads if sketched
            else sv.max_batch) * (sv.spec_k + 1)
    assert rows > ly.padded_rows(rows // (sv.spec_k + 1))
    max_new = sv.decode_chunk if sketched else 6
    reqs = _requests(tcfg, 13, [60, 70, 44] if sketched else [5, 16, 9, 23],
                     max_new=max_new)
    plain, ref = _run(tcfg, params, dataclasses.replace(sv, spec_k=0), reqs)
    spec, got = _run(tcfg, params, sv, reqs)
    assert got == ref
    st = spec.stats()
    assert st.spec_rounds > 0
    if sketched:
        assert spec.fold_rows_total == plain.fold_rows_total > 0
        # one round a request: every proposal inside its budget accepted
        assert st.spec_accepted == st.spec_rounds * (max_new - 1)


def test_prefix_hit_forks_shared_blocks(gemma):
    """A hit on a cached full-prompt prefix: the boundary block the slot
    would write is forked (copy-on-write, both pools), the cached
    entry's blocks stay bitwise unchanged, the hit's tokens equal the
    cold miss's, and the books conserve."""
    _, _, tcfg, tparams = gemma
    sched = SlotScheduler(tcfg, tparams, serve=_serve(
        tcfg, spec_k=3, draft_depth=1, admit_threshold=2), device="cpu")
    prompt = np.random.RandomState(9).randint(
        0, tcfg.vocab_size, (32,)).astype(np.int32)
    outs = [sched.run([Request(rid=i, tokens=prompt, max_new=6)])[0]
            for i in range(2)]
    key = tuple(int(t) for t in prompt)
    ids = list(sched.prefix_cache._entries[key].block_ids)
    assert len(ids) == 2
    pools = lambda: [c["kv"][s][:, ids].clone()
                     for c in (sched._state.cache,
                               sched._state.cache["draft"])
                     for s in ("k", "v")]
    snap = pools()
    free0 = sched.alloc.free_count
    forks = []
    real = sched._copy_block
    sched._copy_block = lambda a, b: (forks.append((a, b)), real(a, b))
    hit = sched.run([Request(rid=9, tokens=prompt, max_new=6)])[0]
    assert hit.prefix_hit
    assert hit.tokens.tolist() == outs[0].tokens.tolist()
    assert forks and all(a in ids and b not in ids for a, b in forks)
    for a, b in zip(snap, pools()):
        assert torch.equal(a, b)
    assert all(int(sched.alloc.rc[b]) == 1 for b in ids)
    assert sched.alloc.reserved == sched.prefix_cache.held_blocks()
    assert sched.alloc.free_count == free0
    assert int(sched.alloc.rc.sum()) == sched.alloc.reserved


def test_overhang_past_max_seq_lands_in_the_sink(gemma):
    """A request that fills max_seq: the spec engine reserves its
    spec_k overhang rows (one more block, as the reference's books do),
    the model sees the plain engine's table width, so rejected rows past
    max_seq land in the write sink, and the tokens are the plain
    engine's."""
    _, _, tcfg, tparams = gemma
    reqs = _requests(tcfg, 12, [90, 40], max_new=6)
    plain, ref = _run(tcfg, tparams, _serve(tcfg), reqs)
    sched, got = _run(tcfg, tparams, _serve(tcfg, spec_k=3, draft_depth=1),
                      reqs)
    assert got == ref
    assert sched.attn_blocks == plain.blocks_per_slot == 6
    assert sched.blocks_per_slot == 7
    assert sched.alloc.peak_reserved == plain.alloc.peak_reserved + 2
    sink = sched._state.cache["kv"]["k"][:, sched.num_blocks]
    assert float(sink.abs().sum()) > 0


def test_draft_equal_to_target_accepts_every_proposal(gemma):
    """With the target's upper layers zeroed (their residual outputs add
    nothing) the depth-1 draft is the target bitwise: every proposal is
    accepted and each round advances spec_k + 1 tokens."""
    _, _, tcfg, tparams = gemma
    cfg4 = dataclasses.replace(tcfg, num_layers=4)
    params = tf.init_params(cfg4, seed=2, device="cpu")
    for blk in params["blocks"][1:]:
        blk["attn"]["wo"].zero_()
        blk["ffn"]["w_down"].zero_()
    sched, _ = _run(cfg4, params, _serve(cfg4, spec_k=4, draft_depth=1,
                                         decode_chunk=2),
                    _requests(cfg4, 10, [10, 8], max_new=10))
    st = sched.stats()
    assert st.acceptance_rate == 1.0 and st.mean_accepted_run == 5.0
    assert "speculative: acceptance=1.00" in st.format()


def test_round_accounting():
    assert round_accounting(0, 3) == (0, 0, 0)
    assert round_accounting(3, 0) == (0, 0, 0)
    assert round_accounting(3, 1) == (1, 3, 0)
    assert round_accounting(3, 4) == (1, 3, 3)


def test_sampled_spec_slots_reproducible_by_seed(gemma):
    _, _, tcfg, tparams = gemma
    reqs = make_request_stream(tcfg, np.random.RandomState(8), 5, 2, 16, 8,
                               6, sampled_frac=1.0)
    sv = _serve(tcfg, spec_k=2, draft_depth=1)
    _, a = _run(tcfg, tparams, sv, reqs)
    _, b = _run(tcfg, tparams, sv, reqs)
    assert a == b
    _, other = _run(tcfg, tparams, sv,
                    [dataclasses.replace(r, seed=r.seed + 1) for r in reqs])
    assert other != a


# ---------------------------------------------------------------------------
# Sketched KV under speculation
# ---------------------------------------------------------------------------


def test_sketched_spec_engine_equals_sketched_plain(gemma):
    """A sketched spec engine whose slots fold (both pools, both tails)
    gives the sketched plain engine's tokens bitwise; with a window
    covering the context it gives the sketch-free spec engine's."""
    _, _, tcfg, tparams = gemma
    bs = tcfg.serve.kv_block_size
    sv = _serve(tcfg, max_batch=2, max_seq=256, decode_chunk=2,
                num_kv_blocks=40, kv_sketch_window=4 * bs)
    reqs = _requests(tcfg, 4, [180, 100], max_new=8)
    s0, ref = _run(tcfg, tparams, sv, reqs)
    s1, got = _run(tcfg, tparams, dataclasses.replace(sv, spec_k=2), reqs)
    assert got == ref
    assert s1.fold_rows_total > 0 and s1.stats().spec_rounds > 0
    assert float(s1._state.cache["draft"]["tail"].abs().sum()) > 0
    # the depth-1 draft's tail beside the target's
    assert s1.kv_sketch_tail_bytes() * tcfg.num_layers == \
        s0.kv_sketch_tail_bytes() * (tcfg.num_layers + 1)
    assert s1.alloc.reserved == 0
    sv0 = _serve(tcfg, max_batch=2, spec_k=2, decode_chunk=2)
    short = _requests(tcfg, 2, [9, 18], max_new=5)
    _, ref = _run(tcfg, tparams, sv0, short)
    _, got = _run(tcfg, tparams,
                  dataclasses.replace(sv0, kv_sketch_window=96), short)
    assert got == ref


# ---------------------------------------------------------------------------
# Against the reference engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", ["random", "exact"])
def test_spec_engine_matches_reference(gemma, draft):
    """One stream (shared prefixes, a quarter sampled) through the
    reference's spec engine and the port's, truncation draft of depth 1:
    completion order, allocator books and every stat equal; greedy
    tokens equal while the reference's top-1 margin exceeds MARGIN_TOL.
    The speculative counters depend on which proposals the target
    accepts, so a near-tie that flips a token (in plain decode too)
    changes them: they are held equal with an "exact" draft, the
    target's upper layer zeroed so that the draft is the target in each
    package and every proposal is accepted; with the "random" weights
    they are reported."""
    _match_reference(gemma, draft, dict(max_batch=3, spec_k=3))


def test_spec_engine_at_spec_k_8_matches_reference(gemma):
    """The same at spec_k 8 and max_batch 8 (exact draft): the port's
    verify steps of 72 rows run in two slabs of the decode step's 64
    (models/layers.py, row padding); the reference takes any spec_k."""
    _match_reference(gemma, "exact", dict(max_batch=8, spec_k=8))


def _match_reference(gemma, draft, kw):
    cfg, params, tcfg, tparams = gemma
    if draft == "exact":
        blocks = dict(params["blocks"])
        blocks["attn"] = dict(blocks["attn"], wo=blocks["attn"]["wo"].at[
            1:].set(0))
        blocks["ffn"] = dict(blocks["ffn"], w_down=blocks["ffn"][
            "w_down"].at[1:].set(0))
        params = dict(params, blocks=blocks)
        tparams = bridge.from_reference(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
    stream = (12, 2, 32, 16, 8)
    kw = dict(kw, draft_depth=1, admit_threshold=2)
    rreqs = ref_stream(cfg, np.random.RandomState(5), *stream,
                       sampled_frac=0.25)
    treqs = make_request_stream(tcfg, np.random.RandomState(5), *stream,
                                sampled_frac=0.25)
    rs = RefScheduler(cfg, params, serve=_serve(cfg, **kw))
    ts = SlotScheduler(tcfg, tparams, serve=_serve(tcfg, **kw),
                       device="cpu")
    rdone, tdone = rs.run(list(rreqs)), ts.run(list(treqs))
    assert [c.rid for c in rdone] == [c.rid for c in tdone]
    assert _books(ts) == (rs.alloc.peak_reserved, rs.alloc.reserved,
                          rs.alloc.rc.tolist(), sorted(rs.alloc._free))
    ref, got = rs.stats(), ts.stats()
    # decode_ and prefill_compilations count XLA compilations in the
    # reference and CUDA graph captures in the port, which runs eagerly on
    # the CPU
    assert (ref.decode_compilations, got.decode_compilations) == (1, 0)
    assert (ref.prefill_compilations, got.prefill_compilations) == (1, 0)
    for f in dataclasses.fields(got):
        if draft == "random" and f.name.startswith("spec_"):
            continue
        if f.name in ("decode_compilations", "prefill_compilations"):
            continue
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert got.spec_rounds > 0 and got.prefix_hits > 0
    if draft == "exact" and kw["spec_k"] == 3:
        assert got.acceptance_rate == 1.0   # 8 tokens: two rounds of 4
    elif draft == "exact":
        assert got.spec_accepted > 0
    greedy = [c for c in rdone if rreqs[c.rid].temperature == 0.0]
    seqs = [np.concatenate([rreqs[c.rid].tokens, c.tokens]) for c in greedy]
    batch = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        batch[i, :len(s)] = s
    y, _, _ = rtf.forward(params, rtf.embed_inputs(
        params, {"tokens": jnp.asarray(batch)}, cfg), cfg, mode="train")
    lg = np.asarray(rly.logits_fn(params, y, cfg))[..., :cfg.vocab_size]
    tby = {c.rid: c for c in tdone}
    compared = 0
    for i, c in enumerate(greedy):
        S = len(rreqs[c.rid].tokens)
        srt = np.sort(lg[i, S - 1:S - 1 + len(c.tokens)], axis=-1)
        small = srt[:, -1] - srt[:, -2] < MARGIN_TOL
        n = int(np.argmax(small)) if small.any() else len(small)
        np.testing.assert_array_equal(tby[c.rid].tokens[:n], c.tokens[:n])
        compared += n
    assert compared >= 16, compared


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def test_engines_carry_spec_k(gemma):
    """ServeEngine.generate takes spec_k as a scalar or per request and
    shares one draft across its schedulers; AsyncServeEngine.submit
    passes it through; greedy output equals a plain engine's."""
    _, _, tcfg, tparams = gemma
    scfg = dataclasses.replace(tcfg, serve=dataclasses.replace(
        tcfg.serve, spec_k=3, draft_depth=1))
    prompts = np.random.RandomState(11).randint(0, tcfg.vocab_size, (3, 12))
    ref = ServeEngine(tcfg, tparams, max_seq=96, device="cpu").generate(
        prompts, max_new=5).tokens
    eng = ServeEngine(scfg, tparams, max_seq=96, device="cpu")
    got = eng.generate(prompts, max_new=5, spec_k=[3, 0, 2]).tokens
    assert torch.equal(got, ref)
    assert torch.equal(eng.generate(prompts, max_new=5).tokens, ref)
    got2 = eng.generate(prompts[:2], max_new=5).tokens   # another batch
    assert torch.equal(got2, ref[:2])
    drafts = {id(f.scheduler.draft) for f in eng._frontends.values()}
    assert len(eng._frontends) == 2 and len(drafts) == 1
    assert eng.stats().spec_rounds > 0

    async def go():
        front = AsyncServeEngine(scfg, tparams, serve=_serve(
            tcfg, spec_k=3, draft_depth=1), device="cpu")
        hs = [await front.submit(p, max_new=5, spec_k=k)
              for p, k in zip(prompts, (3, 0, 1))]
        return front, [await h.result() for h in hs]

    front, done = asyncio.run(go())
    assert [c.tokens.tolist() for c in done] == ref.tolist()
    assert front.scheduler._slot_spec == [0, 0]      # released at retire


@pytest.mark.parametrize("ratio", [0, 2])
def test_launcher_spec_drive(capsys, ratio):
    launch.main(["--device", "cpu", "--requests", "6", "--max-new", "6",
                 "--spec-k", "3", "--draft-depth", "1",
                 "--draft-sketch-ratio", str(ratio)])
    out = capsys.readouterr().out
    assert "speculative: acceptance=" in out
    assert f"sketched head: {ratio > 0}" in out
    assert "statuses: {'ok': 6}" in out
