"""Port parity: speculative decoding of the moe family and of attention
biases against the JAX package, on reduced granite-moe-3b-a800m,
deepseek-moe-16b and qwen2.5-32b with the reference's parameters carried
across by models/bridge.py.

The compressed draft.  The reference flattens each stacked block leaf to
(lead, d_in, d_out) and reconstructs slice i under seed leaf_seed + i:
a (L, E, d, f) expert stack gives expert e of layer l the seed
leaf_seed + l E + e, the f32 router (L, d, E) and the shared experts
(L, d, f) the seed leaf_seed + l.  Both packages' ``_cs_reconstruct``
calls are recorded by a spy and must be the same set of (d_in, d_out,
ratio, rows, seed).  Reconstructed leaves: the two packages sum the same
f32 count sketch in different orders, so an f32 leaf (the router) agrees
to f32 rounding (1e-5 of the leaf's largest entry) and a bf16 leaf to
one bf16 rounding of it (2^-8 of its largest entry).  The 1-D leaves
(norms, the attention biases) pass through bitwise.

The streams follow tests/test_torch_moe_serve.py: scheduling is integer
bookkeeping and must be equal (completion order, books, every stat,
speculative counters included); greedy tokens are compared while the
reference's margin exceeds MARGIN_TOL (MOE_MARGIN for the moe family)
and, for the moe family, until a request's context first routes apart
between the packages (``Routes``: a near-tie that rounding flips).  The draft is the target's first layer
and the target's upper layers are zeroed (attention ``wo``, the experts'
``we_down`` and the shared experts' ``ws_down``, or the GLU's
``w_down``), so the draft proposes the target's greedy token unless the
target's verify step drops a choice that the draft's micro-step kept."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import make_request_stream as ref_stream
from repro.models import draft as rdr
from repro_torch.launch.serve import make_request_stream
from repro_torch.models import bridge
from repro_torch.models import draft as dr
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.routing import RoutingProbe
from test_torch_moe_serve import (MARGIN_TOL, STREAM, Routes,
                                  _assert_schedule_equal,
                                  _compare_greedy, _configs, _params,
                                  _run_both, _serve)

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -8
F32_TOL = 1e-5
# the exact-target moe models' logits differ between the packages by up
# to 0.0703 (deepseek) and 0.0625 (granite) on dropless full-sequence
# forwards of the stream's first six prompts (median 0.031 / 0.027:
# bf16 logits a few 1/128 apart), three times MARGIN_TOL's 0.02 of the
# dense models: greedy tokens are compared above this margin
MOE_MARGIN = 0.1
MOE = ["granite-moe-3b-a800m", "deepseek-moe-16b"]


def _recorded(monkeypatch, module, run):
    """(d_in, d_out, ratio, rows, seed) of every ``_cs_reconstruct`` call
    ``run()`` makes through ``module``, and run()'s result."""
    calls = []
    real = module._cs_reconstruct

    def spy(w, ratio, rows, seed):
        calls.append((int(w.shape[0]), int(w.shape[1]), ratio, rows, seed))
        return real(w, ratio, rows, seed)

    monkeypatch.setattr(module, "_cs_reconstruct", spy)
    out = run()
    monkeypatch.setattr(module, "_cs_reconstruct", real)
    return calls, out


@pytest.mark.parametrize("arch", MOE)
def test_compressed_moe_draft_leaves_and_seeds_equal_reference(
        monkeypatch, arch):
    cfg, tcfg = _configs(arch)
    params, tparams = _params(cfg, tcfg)
    depth, ratio = 2, 2
    ref_names = ["/".join(str(getattr(k, "key", k)) for k in path)
                 for path, leaf in jax.tree_util.tree_flatten_with_path(
                     params["blocks"])[0] if leaf.ndim >= 3]
    assert [n for n, _ in dr.block_matrices(tparams["blocks"][0])] == \
        ref_names
    assert {"moe/router", "moe/we_gate", "moe/we_up", "moe/we_down"} <= \
        set(ref_names)
    rcalls, (rp, rcfg) = _recorded(
        monkeypatch, rdr,
        lambda: rdr.compress_params(params, cfg, depth, ratio))
    tcalls, (tp, dcfg) = _recorded(
        monkeypatch, dr,
        lambda: dr.compress_params(tparams, tcfg, depth, ratio))
    E = tcfg.moe.num_experts
    # per layer: every expert of three expert stacks, the router, the
    # shared experts' three matrices (deepseek) and four attention ones
    per_layer = 3 * E + 1 + 4 + (3 if tcfg.moe.num_shared_experts else 0)
    assert len(tcalls) == depth * per_layer
    assert sorted(tcalls) == sorted(rcalls) and \
        len(set(tcalls)) == len(tcalls)
    seed = tcfg.sketch.seed
    for l in range(depth):
        for name in ("moe/we_gate", "moe/we_down"):
            for e in (0, E - 1):
                assert any(c[4] == dr.leaf_seed(name, seed) + l * E + e
                           for c in tcalls), (name, l, e)
        assert any(c[4] == dr.leaf_seed("moe/router", seed) + l
                   and c[1] == E for c in tcalls)
    assert rcfg.sketch.head_hash_len == dcfg.sketch.head_hash_len
    want = bridge.from_reference(jax.tree.map(np.asarray, rp), dcfg,
                                 device="cpu")
    for (name, a), (_, b) in zip(tf.param_leaves(want), tf.param_leaves(tp)):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype, name
            if x.ndim < 2:
                assert torch.equal(x, y), name
                continue
            rel = F32_TOL if x.dtype == torch.float32 else BF16_ULP
            x, y = x.float(), y.float()
            tol = rel * x.abs().max().item()
            assert (x - y).abs().max().item() <= tol, name
    d0, t0 = tp["blocks"][0]["moe"], tparams["blocks"][0]["moe"]
    assert d0["router"].dtype == torch.float32
    for k in d0:
        assert not torch.equal(d0[k], t0[k]), k


def _exact_target(cfg, params):
    """The reference's params with every layer above the first adding
    nothing to the residual stream, so a depth-1 draft is the target."""
    blocks = dict(params["blocks"])
    blocks["attn"] = dict(blocks["attn"], wo=blocks["attn"]["wo"].at[
        1:].set(0))
    if cfg.family == "moe":
        m = dict(blocks["moe"])
        for k in ("we_down", "ws_down"):
            if k in m:
                m[k] = m[k].at[1:].set(0)
        blocks["moe"] = m
    else:
        blocks["ffn"] = dict(blocks["ffn"], w_down=blocks["ffn"][
            "w_down"].at[1:].set(0))
    return dict(params, blocks=blocks)


# arch: serve knobs of both engines.  The reduced moe's C is 12 rows an
# expert (in groups of 32 tokens), so its 3 slots x 4 verify rows never
# drop a choice and the speculative counters are equal (a verify step
# that drops is held to the reference's by
# test_moe_verify_step_drops_like_reference: in a stream, a drop that a
# near-tie moves between the packages changes which proposals are
# accepted).  qwen2.5-32b at 16 slots x 5 verify rows = 80 rows runs its
# verify steps in two slabs of the decode step's 64 rows
# (models/layers.py, row padding)
STREAMS = {"granite-moe-3b-a800m": {}, "deepseek-moe-16b": {},
           "qwen2.5-32b": {"max_batch": 16, "spec_k": 4}}


@pytest.mark.parametrize("arch", sorted(STREAMS))
def test_moe_spec_stream_matches_reference(monkeypatch, arch):
    """A speculative stream (shared prefixes, a quarter sampled) through
    both packages' spec engines with the exact depth-1 draft: every
    proposal that the budget leaves room for is accepted (qwen2.5's
    spec_k 4 overruns the 8-token budget in each request's second
    round)."""
    cfg, tcfg = _configs(arch)
    params, _ = _params(cfg, tcfg)
    params = _exact_target(cfg, params)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    kw = dict(spec_k=3, draft_depth=1, max_batch=3)
    kw.update(STREAMS[arch])
    reqs = ref_stream(cfg, np.random.RandomState(6), *STREAM,
                      sampled_frac=0.25)
    treqs = make_request_stream(tcfg, np.random.RandomState(6), *STREAM,
                                sampled_frac=0.25)
    routes = None
    if tcfg.family == "moe":
        routes = Routes(monkeypatch, cfg, tcfg, kw["max_batch"],
                        draft_layers=kw["draft_depth"])
    rs, ts, rdone, tdone = _run_both(cfg, params, tcfg, tparams, reqs,
                                     treqs, routes, **kw)
    first = None
    if routes is not None:
        first = routes.first_flips(reqs, tdone, STREAM[2])
        monkeypatch.undo()
        verify = [c for c, cx in routes.port.contexts()
                  if cx is not None and cx[0] == "decode"]
        assert verify and all(c.positions.shape[1] == kw["spec_k"] + 1
                              for c in verify)
        assert all(bool(c.keep.all()) for c in verify)
    _assert_schedule_equal(rs, ts, rdone, tdone)
    st = ts.stats()
    want = 1.0 if kw["spec_k"] == 3 else 0.75
    assert st.spec_rounds > 0 and st.acceptance_rate == want
    assert all(((0 <= c.tokens) & (c.tokens < tcfg.vocab_size)).all()
               for c in tdone)
    moe_family = tcfg.family == "moe"
    n = _compare_greedy(cfg, params, reqs, rdone, tdone, first,
                        MOE_MARGIN if moe_family else MARGIN_TOL)
    # the moe streams compare 15-19 of their 96 greedy tokens above
    # MOE_MARGIN at this size
    assert n >= (12 if moe_family else 2 * len(reqs)), (n, first)


@pytest.mark.parametrize("arch", MOE)
def test_moe_verify_rows_are_decode_rows(arch):
    """Inside the port a verify step's logits at position index + i are
    bitwise a decode step's after committing the first i + 1 tokens,
    both at one padded row count, as long as the verify step drops
    nothing that the decode steps keep: here 2 slots x 4 rows of the
    reduced moe, below an expert's C.  Then at 24 slots x 4 rows = 96
    verify rows, past the 64 rows of the decode step: the step runs in
    two slabs and its routing groups (32 tokens each) are three, each
    group's experts in a launch of its own; every row that drops no
    choice is still bitwise the decode step's."""
    _, tcfg = _configs(arch)
    params = tf.init_params(tcfg, seed=5, device="cpu")
    for B in (2, 24):
        C, bs, nbs = 4, 8, 6
        NB = B * nbs
        rng = np.random.RandomState(B)
        toks = torch.as_tensor(rng.randint(0, tcfg.vocab_size, (B, C)))
        tables = torch.arange(NB, dtype=torch.int32).reshape(B, nbs)
        pos = torch.as_tensor(rng.randint(0, 30, B).astype(np.int32))
        rows = 64
        cache_v = tf.init_paged_cache(tcfg, NB, bs, device="cpu")
        with RoutingProbe() as rv:
            lg_v, _ = tf.verify_step(params, cache_v, toks, pos, tcfg,
                                     tables, rows=rows)
        cache_d = tf.init_paged_cache(tcfg, NB, bs, device="cpu")
        steps = []
        with RoutingProbe() as rd:
            for i in range(C):
                steps.append(tf.decode_step(params, cache_d,
                                            toks[:, i:i + 1], pos + i, tcfg,
                                            tables, rows=rows)[0])
        L, K = tcfg.num_layers, tcfg.moe.top_k
        kept = lambda c, n: c.keep.reshape(-1, K)[:n].all(-1)
        # a (slot, offset) row is clean when no layer dropped a choice of
        # it in the verify step or in its decode step, and no earlier row
        # of its slot was unclean (its KV feeds the later rows)
        vkeep = torch.stack([kept(c, B * C).view(B, C) for c in rv.calls])
        dkeep = torch.stack([torch.stack([kept(rd.calls[i * L + l], B)
                                          for i in range(C)], dim=1)
                             for l in range(L)])
        clean = torch.cumprod((vkeep.all(0) & dkeep.all(0)).int(),
                              dim=1).bool()
        assert clean.sum() >= B * C // 2, clean
        if B * C <= moe.capacity(tcfg):
            assert bool(clean.all())
        for i in range(C):
            ok = clean[:, i]
            assert torch.equal(lg_v[ok, i], steps[i][ok]), (B, i)


@pytest.mark.parametrize("arch", MOE)
def test_moe_verify_step_drops_like_reference(monkeypatch, arch):
    """A verify step of 4 slots x 8 rows routes 32 tokens in one group,
    past the reduced moe's C = 12 rows an expert, so choices drop (the
    reference drops some in each layer here).  On the same paged KV (the
    reference's prefill, carried across) both packages drop alike: a row
    routes to the same experts in the same order (which orders its
    choices in the experts' k-major queues) except at near-ties
    (``ROUTER_TIE``), each layer whose rows all route alike keeps and
    drops the same choices, and with no row routed apart the logits
    agree as the decode step's do (tests/test_torch_moe.py)."""
    import jax.numpy as jnp
    from repro.models import transformer as rtf
    from test_torch_moe import (ROUTER_TIE, _assert_logits_close,
                                reference_routing)
    cfg, tcfg = _configs(arch)
    params, tparams = _params(cfg, tcfg)
    B, C, bs, nbs = 4, 8, 8, 6
    NB = B * nbs
    K = tcfg.moe.top_k
    rng = np.random.RandomState(7)
    tables = np.arange(NB, dtype=np.int32).reshape(B, nbs)
    lens = np.array([20, 9, 14, 3], np.int32)
    rc = rtf.init_paged_cache(cfg, NB, bs)
    for b, n in enumerate(lens):
        prompt = rng.randint(0, cfg.vocab_size, (1, -(-n // 8) * 8))
        for off in range(0, n, 8):
            rc = rtf.prefill_chunk(
                params, rc, jnp.asarray(prompt[:, off:off + 8], jnp.int32),
                jnp.asarray(tables[b]), jnp.int32(off), cfg, kernels=False)
    tc = tf.init_paged_cache(tcfg, NB, bs, device="cpu")
    for kv in ("k", "v"):
        tc["kv"][kv][:, :NB] = bridge.to_torch(np.asarray(rc["kv"][kv]),
                                               "cpu")
    toks = rng.randint(0, cfg.vocab_size, (B, C)).astype(np.int32)
    (rlg, _), rseen = reference_routing(monkeypatch, lambda: rtf.verify_step(
        params, rc, jnp.asarray(toks), jnp.asarray(lens), cfg,
        tables=jnp.asarray(tables), kernels=False))
    with RoutingProbe() as probe:
        tlg, _ = tf.verify_step(tparams, tc, torch.as_tensor(toks).long(),
                                torch.as_tensor(lens), tcfg,
                                torch.as_tensor(tables), rows=64)
    assert len(rseen) == len(probe.calls) == tcfg.num_layers
    apart = held = 0
    for a, c in zip(rseen, probe.calls):
        a = torch.as_tensor(np.array(a)).long().reshape(c.topi.shape)
        rkeep = moe.queue(a, tcfg)[1]
        assert not bool(rkeep.all()), c.layer       # the reference drops
        moved = (a != c.topi).any(-1)
        if apart == 0:
            assert bool((c.margin(K)[moved] < ROUTER_TIE).all()), c.layer
            if not moved.any():
                assert torch.equal(c.keep, rkeep), c.layer
                held += 1
        apart += int(moved.sum())
    assert held >= 1
    if apart == 0:
        _assert_logits_close(np.asarray(rlg)[..., :cfg.vocab_size],
                             tlg.numpy()[..., :cfg.vocab_size])
