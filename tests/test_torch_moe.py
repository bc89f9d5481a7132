"""Port parity: the moe family and the other attention configs of
``repro_torch`` (granite-moe-3b-a800m, deepseek-moe-16b, minitron-4b,
qwen2.5-32b, musicgen-medium, internvl2-2b) against the JAX package, on
their reduced configs with the reference's own parameters carried
across by models/bridge.py.

Tolerances.  Configs are equal field by field.  The bridge is exact.
Routing is integer work on f32 router probabilities: the top-k indices,
the kept mask and the queue positions must be bitwise the reference's
wherever each token's routing margin (models/routing.py: the smallest
router-logit gap among its top K + 1) exceeds ``ROUTE_MARGIN``
(asserted: the two packages round the f32 router product apart by
~1e-7), and the zero pad rows' exact ties must break as the
reference's do.  The MoE output is bf16 GEMMs summed in different
orders: within ``OUT_TOL`` (2%) of max|out| (about one bf16 ulp at
these sizes); the aux loss within 1e-6 relative.  Model logits follow
tests/test_torch_model.py: 3% of max|logit| (measured below 2%), greedy
argmax equal where the reference's margin exceeds twice that."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import layers as rly
from repro.models import moe as rmoe
from repro.models import transformer as rtf
from repro_torch.configs import registry
from repro_torch.models import bridge
from repro_torch.models import layers as ly
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.routing import RoutingProbe
from repro_torch.serve.scheduler import Request, SlotScheduler

torch.set_num_threads(1)

NEW_ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b", "minitron-4b",
             "qwen2.5-32b", "musicgen-medium", "internvl2-2b"]
MOE_ARCHS = NEW_ARCHS[:2]
# router-logit gaps (models/routing.py).  ROUTER_TIE: the rows that
# route apart between the packages at these sizes have margins up to
# 0.0105 (bf16 activations rounded apart, about 1% of a router logit)
ROUTE_MARGIN = 1e-4
ROUTER_TIE = 0.02
OUT_TOL = 0.02
LOGIT_TOL = 0.03
POOL_TOL = 0.02
NB, BS, NBS = 16, 8, 6


def _same_fields(a, b):
    """Two config dataclasses (one of each package) equal field by
    field, nested blocks included."""
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_the_reference(arch):
    _same_fields(registry.get_config(arch), rreg.get_config(arch))
    _same_fields(registry.reduced_config(arch), rreg.reduced_config(arch))


def test_only_the_recurrent_archs_raise():
    # the recurrent archs resolve since they were ported (their configs
    # are held in tests/test_torch_ssm.py) and train
    # (tests/test_torch_train_families.py); what they still refuse is a
    # kv-cache entry point, as the reference does
    assert registry.ARCH_IDS == rreg.ARCH_IDS
    for arch in ("xlstm-1.3b", "zamba2-2.7b"):
        with pytest.raises(ValueError, match="attention family"):
            tf.init_paged_cache(registry.reduced_config(arch), 4, 8, "cpu")
    assert registry.all_configs().keys() == set(registry.ARCH_IDS)


def test_capacity_is_the_references():
    for arch in MOE_ARCHS:
        for get in ("get_config", "reduced_config"):
            cfg = getattr(registry, get)(arch)
            assert moe.capacity(cfg) == rmoe.capacity(
                getattr(rreg, get)(arch))
    assert [moe.capacity(registry.get_config(a)) for a in MOE_ARCHS] == \
        [40, 20]
    assert moe.capacity(registry.reduced_config(MOE_ARCHS[0])) == 12


# ---------------------------------------------------------------------------
# moe_ffn against repro.models.moe
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE_ARCHS)
def experts(request):
    """One layer's MoE parameters of the reference, carried across."""
    cfg = rreg.reduced_config(request.param)
    tcfg = registry.reduced_config(request.param)
    p = rmoe.init_moe(jax.random.PRNGKey(0), cfg)
    tp = {k: bridge.to_torch(np.asarray(v), "cpu") for k, v in p.items()}
    return cfg, tcfg, p, tp


def _reference_routing(monkeypatch, p, xj, cfg):
    """The reference's own (y, aux, topi, pos, keep): its ``top_k`` and
    queue ``cumsum`` outputs recorded as ``moe_ffn`` runs (eagerly), then
    read as the reference reads them."""
    seen = {}
    top_k, cumsum = jax.lax.top_k, jnp.cumsum

    def rec_top_k(a, k):
        seen["top"] = top_k(a, k)
        return seen["top"]

    def rec_cumsum(a, axis=None, **kw):
        seen["cum"] = cumsum(a, axis=axis, **kw)
        return seen["cum"]

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jnp, "cumsum", rec_cumsum)
    y, aux = rmoe.moe_ffn(p, xj, cfg)
    monkeypatch.undo()
    topi = np.asarray(seen["top"][1])                        # (G, g, K)
    G, g, K = topi.shape
    E = cfg.moe.num_experts
    # pos_flat (G, K*g, E) holds cumsum - 1 of the k-major one-hots
    cum = np.asarray(seen["cum"]).reshape(G, K, g, E).transpose(0, 2, 1, 3)
    pos = np.take_along_axis(cum, topi[..., None], -1)[..., 0] - 1
    return y, aux, topi, pos.astype(np.int64), pos < rmoe.capacity(cfg)


# (B, S, seed): decode rows; one chunk; T = 46 not a multiple of g = 32
# (a zero-padded group); 160 tokens in five full groups, where experts
# overflow their 12 rows
CASES = {"decode": (3, 1, 0), "chunk": (1, 16, 1), "ragged": (2, 23, 2),
         "drops": (4, 40, 3)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_reference(monkeypatch, experts, case):
    cfg, tcfg, p, tp = experts
    B, S, seed = CASES[case]
    x = np.random.RandomState(seed).randn(B, S, cfg.d_model)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = bridge.to_torch(np.asarray(xj), "cpu")
    y, aux, topi, pos, keep = _reference_routing(monkeypatch, p, xj, cfg)
    with RoutingProbe() as probe:
        ty = moe.moe_ffn(tp, xt, tcfg)
    (call,) = probe.calls
    ti, tkeep = call.topi, call.keep
    tpos, _ = moe.queue(ti, tcfg)
    taux = moe.aux_loss(call.probs, ti, tcfg)

    T = B * S
    G, g, K = topi.shape
    live = (np.arange(G * g) < T).reshape(G, g)
    margin = call.margin(K).numpy()
    assert margin[live].min() > ROUTE_MARGIN, margin[live].min()
    # the pad rows' probabilities tie exactly; the lower index wins
    np.testing.assert_array_equal(ti.numpy()[~live],
                                  np.broadcast_to(np.arange(K),
                                                  ti[~live].shape))
    np.testing.assert_array_equal(ti.numpy(), topi)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    if case == "drops":                # the reference dropped real tokens
        assert not keep[live].all()
    y = np.asarray(y.astype(jnp.float32))
    np.testing.assert_allclose(ty.float().numpy(), y, rtol=0,
                               atol=OUT_TOL * np.abs(y).max())
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-6)


def test_moe_ffn_routes_only_the_live_rows(experts):
    """A decode step's rows padded to 64 (models/layers.py, row padding)
    leave the live rows' block output bitwise unchanged and the padding
    zero; routing the padding with them would change the live rows."""
    _, tcfg, _, tp = experts
    p_l = {"moe": tp, "norm2": torch.zeros(tcfg.d_model, dtype=ly.PDTYPE)}
    B = 8
    x = torch.randn((B, tcfg.d_model), generator=torch.Generator().manual_seed(
        4))
    # row 0's router logits 3, 2, 0, ...: its second choice is expert 0,
    # the first choice of every zero row
    want = torch.zeros(tcfg.moe.num_experts)
    want[:2] = torch.tensor([2.0, 3.0])
    x[0] = torch.linalg.lstsq(tp["router"].t(), want[:, None]).solution[:, 0]
    x = x.to(ly.PDTYPE)
    xp = ly.pad_rows(x, 64)
    # the live rows' MoE alone, on the norm of the padded rows (so that
    # the comparison does not rest on the norm's rounding at two row
    # counts)
    h = ly.rms_norm(xp, p_l["norm2"], tcfg.norm_eps)[:B]
    plain = x + moe.moe_ffn(tp, h.view(B, 1, -1), tcfg).view(B, -1)
    padded = tf._ffn_residual(p_l, xp, tcfg, (B, 1))
    assert torch.equal(padded[:B], plain)
    assert not padded[B:].any()
    everything = tf._ffn_residual(p_l, xp, tcfg, (64, 1))
    assert not torch.equal(everything[:B], plain)


# ---------------------------------------------------------------------------
# The models against the reference
# ---------------------------------------------------------------------------


def _reference_params(cfg):
    """The reference's parameters; a bias config gets nonzero biases (the
    reference initialises them to zero, which would test nothing)."""
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    if cfg.qkv_bias:
        rng = np.random.RandomState(11)
        attn = dict(params["blocks"]["attn"])
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray(0.5 * rng.randn(*attn[k].shape),
                                  jnp.bfloat16)
        params = {**params, "blocks": {**params["blocks"], "attn": attn}}
    return params


@pytest.fixture(scope="module", params=NEW_ARCHS)
def models(request):
    cfg = rreg.reduced_config(request.param)
    tcfg = registry.reduced_config(request.param)
    params = _reference_params(cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return cfg, params, tcfg, tparams


def _assert_logits_close(ref, got):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    tol = LOGIT_TOL * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    srt = np.sort(ref, axis=-1)
    sure = srt[..., -1] - srt[..., -2] > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[sure], ref.argmax(-1)[sure])


def test_bridge_is_exact(models):
    cfg, params, tcfg, tparams = models
    ffn = "moe" if cfg.family == "moe" else "ffn"
    groups = {"attn": params["blocks"]["attn"], ffn: params["blocks"][ffn]}
    for i, blk in enumerate(tparams["blocks"]):
        assert blk.keys() == {"attn", ffn, "norm1", "norm2"}
        for group, leaves in groups.items():
            assert blk[group].keys() == leaves.keys()
            for name, w in blk[group].items():
                ref = np.asarray(leaves[name][i])
                assert str(w.dtype).endswith(ref.dtype.name), name
                np.testing.assert_array_equal(
                    w.view(torch.int16 if ref.dtype.itemsize == 2
                           else torch.int32).numpy(),
                    ref.view(np.int16 if ref.dtype.itemsize == 2
                             else np.int32), err_msg=f"{group}.{name}[{i}]")
    if cfg.qkv_bias:
        assert tparams["blocks"][0]["attn"]["bq"].abs().max() > 0
    if cfg.family == "moe":
        assert tparams["blocks"][0]["moe"]["router"].dtype == torch.float32


def test_init_params_shaped_as_the_reference(models):
    cfg, params, tcfg, _ = models
    a = tf.init_params(tcfg, seed=3, device="cpu")
    b = tf.init_params(tcfg, seed=3, device="cpu")
    ref_leaves = {path: leaf for path, leaf in
                  jax.tree_util.tree_flatten_with_path(params)[0]}
    got = tf.param_leaves(a)
    assert len(got) == len(ref_leaves)
    for (path, pieces), (rpath, leaf) in zip(got, ref_leaves.items()):
        names = "/".join(str(getattr(k, "key", k)) for k in rpath)
        assert path == names
        stacked = path.startswith("blocks/")
        shape = leaf.shape[1:] if stacked else leaf.shape
        assert len(pieces) == (cfg.num_layers if stacked else 1)
        for w in pieces:
            assert tuple(w.shape) == tuple(shape), path
            assert str(w.dtype).endswith(leaf.dtype.name), path
    for (_, pa), (_, pb) in zip(got, tf.param_leaves(b)):
        assert all(torch.equal(u, v) for u, v in zip(pa, pb))


def port_routing(run):
    """Run ``run()`` recording every MoE call of the port
    (models/routing.py): (result, [(topi (rows, K), margin (rows,)) per
    call])."""
    with RoutingProbe() as probe:
        res = run()
    seen = []
    for c in probe.calls:
        K = c.topi.shape[-1]
        seen.append((c.topi.reshape(-1, K).numpy(),
                     c.margin(K).reshape(-1).numpy()))
    return res, seen


def reference_routing(monkeypatch, run):
    """Run ``run()`` (reference code, under ``jax.disable_jit`` so its
    layer scan runs eagerly) recording every ``top_k`` of its MoE:
    (result, [topi (rows, K) per call])."""
    seen = []
    top_k = jax.lax.top_k

    def recording(a, k):
        out = top_k(a, k)
        seen.append(np.asarray(out[1]).reshape(-1, k))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    with jax.disable_jit():
        res = run()
    monkeypatch.undo()
    return res, seen


def flips(ref_seen, port_seen):
    """Per call, the routed rows whose set of choices differs between the
    packages; every such row must be a near-tie (``ROUTER_TIE``) unless
    an earlier call (layer) flipped, whose change its input carries."""
    out = []
    for i, (a, (b, gaps)) in enumerate(zip(ref_seen, port_seen)):
        f = (np.sort(a, -1) != np.sort(b, -1)).any(-1)
        if not any(o.any() for o in out):
            assert (gaps[f] < ROUTER_TIE).all(), (i, gaps[f])
        out.append(f)
    assert len(ref_seen) == len(port_seen)
    return out


def dropless(cfg):
    """``cfg`` with capacity_factor E / K: C >= group_size, so no choice
    is ever dropped and a token's output depends on its own routing
    alone."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def test_forward_matches_reference(monkeypatch, models):
    """Full-sequence logits.  For the moe family, on a dropless copy of
    both configs (drops couple a group's tokens; moe_ffn's tests hold
    them), the reference run layer by layer: the packages route every
    row alike except near-ties (``ROUTER_TIE``), and logits agree at the
    positions with no flipped row at or before them in their sequence (a flip changes that row's expert outputs,
    and through later layers' KV the rest of its sequence)."""
    cfg, params, tcfg, tparams = models
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 20))
    if cfg.family == "moe":
        cfg, tcfg = dropless(cfg), dropless(tcfg)

    def ref_run():
        y, _, _ = rtf.forward(params, rtf.embed_inputs(
            params, {"tokens": jnp.asarray(toks, jnp.int32)}, cfg), cfg,
            mode="train")
        return np.asarray(rly.logits_fn(params, y, cfg))

    def port_run():
        with torch.no_grad():
            y, _ = tf.forward(tparams, tf.embed_inputs(
                tparams, torch.as_tensor(toks)), tcfg, mode="train")
        return ly.logits_fn(tparams, y, tcfg).numpy()

    if cfg.family != "moe":
        _assert_logits_close(ref_run(), port_run())
        return

    def ref_layers():
        # the reference's layer scan body, one layer at a time, so that
        # its routing runs eagerly
        h = rtf.embed_inputs(params, {"tokens": jnp.asarray(toks)}, cfg)
        positions = jnp.arange(toks.shape[1])
        for i in range(cfg.num_layers):
            p_l = jax.tree.map(lambda a: a[i], params["blocks"])
            h, _, _ = rtf._dense_block(p_l, h, cfg, positions, None, None,
                                       "train")
        y = rly.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return np.asarray(rly.logits_fn(params, y, cfg))

    ref, rseen = reference_routing(monkeypatch, ref_layers)
    got, tseen = port_routing(port_run)
    clean = np.ones(toks.shape, bool)
    for f in flips(rseen, tseen):
        clean &= ~np.maximum.accumulate(
            f[:toks.size].reshape(toks.shape), axis=1)
    assert clean.sum() >= toks.size // 4, clean
    _assert_logits_close(ref[clean], got[clean])


def test_prefill_and_decode_match_reference(monkeypatch, models):
    """Three 8-token chunks of one prompt through both packages' paged
    prefill, then decode for three slots (one over the prefilled table,
    one fresh, one idle), its rows padded as an engine's: layer 0's pool
    rows bitwise, the others and the live slots' logits within tolerance
    (for the moe family unless a near-tie flipped, as in
    ``test_forward_matches_reference``; the reference then runs eagerly)."""
    cfg, params, tcfg, tparams = models
    ref_run = lambda: _ref_prefill_and_decode(cfg, params)
    port_run = lambda: _port_prefill_and_decode(tcfg, tparams)
    flipped = False
    if cfg.family == "moe":
        (rc, lg), rseen = reference_routing(monkeypatch, ref_run)
        (tc, tlg), tseen = port_routing(port_run)
        flipped = any(f.any() for f in flips(rseen, tseen))
    else:
        (rc, lg), (tc, tlg) = ref_run(), port_run()
    layer0 = [np.asarray(rc["kv"][kv][0].astype(jnp.float32))
              for kv in ("k", "v")]
    for kv, ref in zip(("k", "v"), layer0):
        np.testing.assert_array_equal(tc["kv"][kv][0, :NB].float().numpy(),
                                      ref)
    if flipped:
        return       # a near-tie flipped: only layer 0 is comparable
    for kv in ("k", "v"):
        ref = np.asarray(rc["kv"][kv].astype(jnp.float32))
        got = tc["kv"][kv][:, :NB].float().numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=POOL_TOL * np.abs(ref).max())
    _assert_logits_close(np.asarray(lg)[:2], tlg.numpy()[:2])


def _paged_inputs(cfg):
    rng = np.random.RandomState(2)
    table = np.full((NBS,), NB, np.int32)
    table[:4] = [3, 7, 1, 9]
    prompt = rng.randint(0, cfg.vocab_size, (1, 24)).astype(np.int32)
    tables = np.full((3, NBS), NB, np.int32)
    tables[0], tables[1, :2] = table, [4, 5]
    idx = np.array([24, 5, 0], np.int32)
    cur = rng.randint(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    return table, prompt, tables, idx, cur


def _ref_prefill_and_decode(cfg, params):
    table, prompt, tables, idx, cur = _paged_inputs(cfg)
    rc = rtf.init_paged_cache(cfg, NB, BS)
    for off in (0, 8, 16):
        rc = rtf.prefill_chunk(params, rc, jnp.asarray(prompt[:, off:off + 8]),
                               jnp.asarray(table), jnp.int32(off), cfg,
                               kernels=False)
    lg, rc = rtf.decode_step(params, rc, jnp.asarray(cur), jnp.asarray(idx),
                             cfg, tables=jnp.asarray(tables), kernels=False)
    return rc, lg


def _port_prefill_and_decode(tcfg, tparams):
    table, prompt, tables, idx, cur = _paged_inputs(tcfg)
    tc = tf.init_paged_cache(tcfg, NB, BS, device="cpu")
    for off in (0, 8, 16):
        tf.prefill_chunk(tparams, tc, torch.as_tensor(prompt[:, off:off + 8]),
                         torch.as_tensor(table), off, tcfg)
    tlg, _ = tf.decode_step(tparams, tc, torch.as_tensor(cur),
                            torch.as_tensor(idx), tcfg,
                            torch.as_tensor(tables), rows=64)
    return tc, tlg


# ---------------------------------------------------------------------------
# Speculation on the new configs
# ---------------------------------------------------------------------------


# the configs whose speculation came last: the moe family (expert stacks
# compressed expert by expert, an f32 router) and qwen2.5-32b's
# attention biases
SPEC_LATE = ["granite-moe-3b-a800m", "deepseek-moe-16b", "qwen2.5-32b"]


@pytest.mark.parametrize("arch", SPEC_LATE)
def test_speculation_on_the_new_configs_names_the_roadmap(arch):
    """The configs that once raised (ROADMAP Queue 1 #20) speculate:
    greedy tokens bitwise the plain engine's through a truncated and a
    count-sketched draft.  The reduced moe's steps of 2 rows and verify
    steps of 2 x 4 rows never fill an expert's C rows, so nothing drops.
    The compressed draft reconstructs every expert slice and keeps the
    router f32; the attention biases pass through as the target's
    layer-0 tensors."""
    tcfg = registry.reduced_config(arch)
    params = tf.init_params(tcfg, seed=0, device="cpu")
    if tcfg.qkv_bias:                  # init_params zeroes them
        g = torch.Generator().manual_seed(4)
        for blk in params["blocks"]:
            for k in ("bq", "bk", "bv"):
                blk["attn"][k] = (0.5 * torch.randn(
                    blk["attn"][k].shape, generator=g)).to(ly.PDTYPE)
    rng = np.random.RandomState(3)
    reqs = [Request(rid=i, tokens=rng.randint(0, tcfg.vocab_size, (n,)
                                              ).astype(np.int32), max_new=6)
            for i, n in enumerate((5, 17, 9))]

    def run(**kw):
        serve = dataclasses.replace(tcfg.serve, max_batch=2, max_seq=64,
                                    decode_chunk=4, prefill_bucket=16, **kw)
        sched = SlotScheduler(tcfg, params, serve=serve, device="cpu")
        done = {c.rid: list(c.tokens) for c in sched.run(list(reqs))}
        return sched, done

    _, plain = run()
    for kw in (dict(draft_depth=1), dict(draft_depth=1,
                                         draft_sketch_ratio=2)):
        sched, got = run(spec_k=3, **kw)
        assert got == plain, kw
        assert sched.stats().spec_rounds > 0
        d0, t0 = sched.draft.params["blocks"][0], params["blocks"][0]
        if tcfg.qkv_bias:
            assert all(d0["attn"][k] is t0["attn"][k]
                       for k in ("bq", "bk", "bv"))
        if tcfg.family == "moe" and kw.get("draft_sketch_ratio"):
            assert d0["moe"]["router"].dtype == torch.float32
            for k in ("we_gate", "we_up", "we_down"):
                assert d0["moe"][k].shape == t0["moe"][k].shape
                assert all(not torch.equal(a, b) for a, b in
                           zip(d0["moe"][k], t0["moe"][k])), k


@pytest.mark.parametrize("arch", sorted(set(NEW_ARCHS) - set(SPEC_LATE)))
def test_greedy_speculation_equals_plain_on_the_new_dense_configs(arch):
    """The dense stacks without biases (minitron-4b; musicgen-medium's
    gelu; internvl2-2b's padded vocab) speculate: greedy tokens bitwise
    the plain engine's, through a truncated and a count-sketched draft."""
    tcfg = registry.reduced_config(arch)
    params = tf.init_params(tcfg, seed=0, device="cpu")
    rng = np.random.RandomState(3)
    reqs = [Request(rid=i, tokens=rng.randint(0, tcfg.vocab_size, (n,)
                                              ).astype(np.int32), max_new=6)
            for i, n in enumerate((5, 17, 9))]

    def run(**kw):
        serve = dataclasses.replace(tcfg.serve, max_batch=2, max_seq=64,
                                    decode_chunk=4, prefill_bucket=16, **kw)
        sched = SlotScheduler(tcfg, params, serve=serve, device="cpu")
        done = {c.rid: list(c.tokens) for c in sched.run(list(reqs))}
        return sched, done

    _, plain = run()
    for kw in (dict(draft_depth=1), dict(draft_depth=1,
                                         draft_sketch_ratio=2)):
        sched, got = run(spec_k=3, **kw)
        assert got == plain, kw
        assert sched.stats().spec_rounds > 0


def test_moe_training_names_the_roadmap():
    # both halves of ROADMAP Queue 1 #20 are done: the moe loss carries
    # the router's aux loss and train() runs
    # (tests/test_torch_train_families.py), and a moe engine speculates
    from repro_torch.train.loop import train
    tcfg = registry.reduced_config("granite-moe-3b-a800m")
    params = tf.init_params(tcfg, seed=0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with torch.no_grad():
        loss = tf.loss_fn(params, {"tokens": toks, "labels": toks}, tcfg)
        y, aux = tf._train_forward(params, tf.embed_inputs(params, toks),
                                   tcfg)
    assert float(aux) > 0
    torch.testing.assert_close(loss, ly.cross_entropy(params, y, toks, tcfg)
                               + aux)
    h = train(tcfg, steps=1, batch=1, seq=8, device="cpu", log_every=1000,
              log_fn=lambda *_: None)
    assert np.isfinite(h.losses).all()
    serve = dataclasses.replace(tcfg.serve, max_batch=2, max_seq=64,
                                spec_k=2)
    sched = SlotScheduler(tcfg, params, serve=serve, device="cpu")
    assert sched.spec_max == 2 and sched.draft.cfg.family == "moe"


def test_drift_tool_runs_on_the_cpu(tmp_path):
    """tools/moe_drift.py on reduced deepseek-moe on the CPU, where the
    kernel path is the plain path: every path's numbers are written, the
    kernel and plain paths agree exactly, and forcing a path onto the
    f32 path's experts leaves its routing no further than the f32
    path's from a tie."""
    import importlib.util
    import json
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "moe_drift.py"
    spec = importlib.util.spec_from_file_location("moe_drift", path)
    drift = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drift)
    out = tmp_path / "drift.json"
    L = registry.reduced_config("deepseek-moe-16b").num_layers
    assert drift.main(["--device", "cpu", "--reduced", "--depths",
                       f"1,{L}", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert len(rec["per_layer"]) == L
    for row in rec["depths"].values():
        assert row["kernel vs plain"] == {"decode_pct": 0.0,
                                          "chunk_pct": 0.0}
        assert row["f32"]["decode_pct_vs_f32"] == 0.0
        assert 0.0 < row["plain@f32"]["decode_pct_vs_f32"] < 3.0

