"""Port parity of the recurrent families' models: ``models/ssm.py``
(Mamba-2, mLSTM, sLSTM), the recurrent paths of ``models/transformer.py``
(train-mode forward, ``prefill``, ``decode_step``, ``init_cache``) and
``models/bridge.py`` (``from_reference``, ``state_from_reference``),
against ``repro.models.ssm`` and ``repro.models.transformer`` on the
reduced xlstm-1.3b and zamba2-2.7b, with the reference's parameters and
inputs made from a numpy seed.

Two kinds of comparison:

* f32: both packages run the same function in f32 (the reference's
  ``PDTYPE`` patched to f32, f32 weights and slot state, so nothing
  rounds to bf16).  These hold every module to the reference tightly:
  ``F32_TOL`` of max|ref|, against float32 rounding of differently
  ordered sums.
* bf16, as served: each block on identical inputs within ``BLOCK_TOL``
  of max|ref| (one bf16 rounding apart: the two libraries round some
  ops differently, e.g. XLA's bf16 sigmoid rounds its exp and add), and
  the whole models within ``MODEL_TOL``.  A random-weight reduced xLSTM
  amplifies a rounding difference through its layers: its bf16 forward
  sits 15-49% of max|logit| from its own f32 run in either package
  (``tools/recurrent_drift.py --device cpu --reduced``), so two bf16
  runs differ by about as much.  zamba2's sit 2-6% apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.configs.registry import reduced_config as ref_reduced
from repro.models import layers as rly
from repro.models import ssm as rssm
from repro.models import transformer as rtf
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.models import bridge
from repro_torch.models import layers as ly
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

ARCHS = ["xlstm-1.3b", "zamba2-2.7b"]
F32_TOL = 2e-4          # of max|ref|, f32 against f32
BLOCK_TOL = 0.03        # of max|ref|, one bf16 block on identical inputs
# of max|logit|, whole bf16 models (see the module docstring)
MODEL_TOL = {"xlstm-1.3b": 0.45, "zamba2-2.7b": 0.12}


def T(a) -> torch.Tensor:
    return bridge.to_torch(np.asarray(a), "cpu")


def close(ref, got, tol, what=""):
    """max|got - ref| <= tol * max|ref| (both as f32)."""
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    g = got.float().numpy()
    assert r.shape == g.shape, (what, r.shape, g.shape)
    assert np.isfinite(g).all(), what
    err, scale = np.abs(r - g).max(), np.abs(r).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def states_close(ref, got, tol, what=""):
    for k in ref:
        if isinstance(ref[k], dict):
            states_close(ref[k], got[k], tol, f"{what}/{k}")
        else:
            close(ref[k], got[k], tol, f"{what}/{k}")


@pytest.fixture
def f32(monkeypatch):
    """The reference computing in f32: its bf16 casts patched to f32."""
    monkeypatch.setattr(rly, "PDTYPE", jnp.float32)
    monkeypatch.setattr(rssm, "PDTYPE", jnp.float32)


def _to32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _x(cfg, B, S, seed=0, dtype=jnp.bfloat16):
    return jnp.asarray(np.random.RandomState(seed).randn(B, S, cfg.d_model),
                       dtype)


# ---------------------------------------------------------------------------
# Configs, init, bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_equal_the_reference(arch):
    assert repr(get_config(arch)) == repr(ref_config(arch))
    assert repr(reduced_config(arch)) == repr(ref_reduced(arch))
    assert get_config(arch).param_count() == {
        "xlstm-1.3b": 3_606_538_240, "zamba2-2.7b": 2_527_245_248}[arch]
    assert get_config(arch).param_count() == ref_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The port's own init: every leaf the reference's shape and dtype in
    the reference's flatten order, as many parameters as the reference's
    tree, and the reference's fixed inits (Mamba-2's A_log = log(1..H), D = 1,
    dt in [0.001, 0.1); mLSTM's wf = 0, forget bias 3; sLSTM's forget
    bias 1)."""
    cfg = reduced_config(arch)
    ref = jax.tree.map(np.asarray, rtf.init_params(jax.random.PRNGKey(0),
                                                   ref_reduced(arch)))
    got = tf.init_params(cfg, seed=3, device="cpu")
    bridged = bridge.from_reference(ref, cfg, device="cpu")
    shape = lambda t: (tuple(t.shape), t.dtype)
    assert tf.tree_map(shape, got) == tf.tree_map(shape, bridged)
    leaves = tf.param_leaves(got)
    assert [p for p, _ in leaves] == [
        "/".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert sum(t.numel() for _, pieces in leaves for t in pieces) == \
        sum(a.size for a in jax.tree.leaves(ref))
    blocks = got["blocks"]
    if arch == "zamba2-2.7b":
        H = ssm.mamba2_dims(cfg)[1]
        for p in blocks["mamba"]:
            assert torch.equal(p["A_log"], torch.log(torch.arange(1.0, H + 1)))
            assert torch.equal(p["D"], torch.ones(H))
            dt = torch.nn.functional.softplus(p["dt_bias"])
            assert ((dt > 0.00099) & (dt < 0.1001)).all()
    else:
        for p in blocks["mlstm"]:
            assert not p["wf"].any() and (p["bf"] == 3.0).all()
        for p in blocks["slstm"]:
            assert (p["bf"] == 1.0).all() and not p["bi"].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_params_and_state_exactly(arch):
    cfg, tcfg = ref_reduced(arch), reduced_config(arch)
    params = rtf.init_params(jax.random.PRNGKey(1), cfg)
    got = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    kinds = params["blocks"]
    for kind, sub in kinds.items():
        for i, layer in enumerate(got["blocks"][kind]):
            ref_layer = jax.tree.map(lambda a: a[i], sub)
            tf.tree_map(lambda g, r: np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(r, np.float32)), layer,
                jax.tree.map(np.asarray, ref_layer))
    _, cache = rtf.prefill(params, {"tokens": jnp.arange(5)[None] + 3}, cfg)
    port = bridge.state_from_reference(jax.tree.map(np.asarray, cache),
                                       device="cpu")
    tf.tree_map(lambda g, r: np.testing.assert_array_equal(
        g.float().numpy(), np.asarray(r, np.float32)), port,
        jax.tree.map(np.asarray, cache))
    empty = tf.init_cache(tcfg, 3, 16, "cpu")
    ref_empty = rtf.init_cache(cfg, 3, 16)
    assert tf.tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                       empty) == jax.tree.map(
        lambda a: (a.shape, str(a.dtype)), ref_empty)


# ---------------------------------------------------------------------------
# Conv helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_conv_stash_left_pads_short_prompts(S):
    """The decode conv buffer of an S-token prompt: its last 3 inputs,
    zero history first, bitwise the reference's."""
    x = jnp.asarray(np.random.RandomState(S).randn(2, S, 8), jnp.bfloat16)
    got = ssm._conv_stash(T(x), 3)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(
        rssm._conv_stash(x, 3), np.float32))
    assert not got[:, :3 - min(S, 3)].any()


def test_causal_conv_and_step_are_the_references():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, 9, 16), jnp.bfloat16)
    w = jnp.asarray(rng.randn(4, 16), jnp.bfloat16)
    b = jnp.asarray(rng.randn(16), jnp.bfloat16)
    np.testing.assert_array_equal(
        ssm._causal_conv(T(x), T(w), T(b)).float().numpy(),
        np.asarray(rssm._causal_conv(x, w, b), np.float32))
    buf = jnp.asarray(rng.randn(2, 3, 16), jnp.bfloat16)
    ref_buf, ref_y = rssm._conv_step(buf, x[:, :1], w, b)
    tbuf = T(buf)
    got_y = ssm._conv_step(tbuf, T(x[:, :1]), T(w), T(b))
    np.testing.assert_array_equal(tbuf.float().numpy(),
                                  np.asarray(ref_buf, np.float32))
    close(ref_y, got_y, 0.01, "conv step")


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------


def _ssd_inputs(S, seed, dtype):
    rng = np.random.RandomState(seed)
    B, H, P, N = 2, 4, 8, 16
    X = jnp.asarray(rng.randn(B, S, H, P), dtype)
    dt = jnp.asarray(np.log1p(np.exp(rng.randn(B, S, H) - 1.0)),
                     jnp.float32)
    A = -jnp.asarray(np.arange(1, H + 1), jnp.float32)
    Bm = jnp.asarray(rng.randn(B, S, N), dtype)
    Cm = jnp.asarray(rng.randn(B, S, N), dtype)
    init = jnp.asarray(rng.randn(B, H, N, P), jnp.float32)
    return X, dt * A, dt, Bm, Cm, init


@pytest.mark.parametrize("S,init", [(32, False), (32, True), (27, False),
                                    (27, True), (5, True)])
@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_ssd_chunked(S, init, prec, monkeypatch):
    """The chunked SSD scan with chunks of 8: whole chunks and a padded
    tail, with and without an initial state."""
    if prec == "f32":
        monkeypatch.setattr(rssm, "PDTYPE", jnp.float32)
    dtype = jnp.bfloat16 if prec == "bf16" else jnp.float32
    X, dtA, dt, Bm, Cm, st = _ssd_inputs(S, S + init, dtype)
    st = st if init else None
    rY, rF = rssm._ssd_chunked(X, dtA, dt, Bm, Cm, 8, init_state=st)
    gY, gF = ssm._ssd_chunked(T(X), T(dtA), T(dt), T(Bm), T(Cm), 8,
                              init_state=None if st is None else T(st))
    tol = BLOCK_TOL if prec == "bf16" else F32_TOL
    close(rY, gY, tol, "Y")
    close(rF, gF, tol, "final state")


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_mamba2_block_prefill_and_decode(prec, monkeypatch):
    """Full sequence with ``want_state`` (prompt 21 over chunks of 16),
    then two decode steps from the reference's state, the port's updated
    in place."""
    cfg = ref_reduced("zamba2-2.7b")
    tcfg = reduced_config("zamba2-2.7b")
    p = rssm.init_mamba2(jax.random.PRNGKey(2), cfg)
    dtype = jnp.bfloat16
    if prec == "f32":
        monkeypatch.setattr(rssm, "PDTYPE", jnp.float32)
        p, dtype = _to32(p), jnp.float32
    tp = {k: T(v) for k, v in p.items()}
    tol = BLOCK_TOL if prec == "bf16" else F32_TOL
    x = _x(cfg, 2, 21, 3, dtype)
    ro, rs = rssm.mamba2_block(p, x, cfg, want_state=True)
    go, gs = ssm.mamba2_block(tp, T(x), tcfg, want_state=True)
    close(ro, go, tol, "prefill out")
    states_close(rs, gs, tol, "prefill state")
    state = {k: T(v) for k, v in rs.items()}
    addrs = {k: v.data_ptr() for k, v in state.items()}
    for t in range(2):
        xt = _x(cfg, 2, 1, 10 + t, dtype)
        ro, rs = rssm.mamba2_block(p, xt, cfg, state=rs)
        go, back = ssm.mamba2_block(tp, T(xt), tcfg, state=state)
        assert back is state
        close(ro, go, tol, f"decode out {t}")
        states_close(rs, state, tol, f"decode state {t}")
    assert {k: v.data_ptr() for k, v in state.items()} == addrs


# ---------------------------------------------------------------------------
# mLSTM, sLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,q_chunk", [(20, 8), (5, 8), (12, 512)])
@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_mlstm_block_parallel_and_step(S, q_chunk, prec, monkeypatch):
    """The parallel form over query chunks of min(q_chunk, S) rows (S above
    and below the chunk), its closed-form final state, then a recurrent
    step from the reference's state, the port's updated in place."""
    cfg = ref_reduced("xlstm-1.3b")
    tcfg = reduced_config("xlstm-1.3b")
    p = rssm.init_mlstm(jax.random.PRNGKey(4), cfg)
    # a nonzero forget projection, so the gates vary over time
    p["wf"] = jnp.asarray(np.random.RandomState(1).randn(*p["wf"].shape)
                          * 0.1, jnp.float32)
    dtype = jnp.bfloat16
    if prec == "f32":
        monkeypatch.setattr(rssm, "PDTYPE", jnp.float32)
        p, dtype = _to32(p), jnp.float32
    tp = {k: T(v) for k, v in p.items()}
    tol = BLOCK_TOL if prec == "bf16" else F32_TOL
    x = _x(cfg, 2, S, S, dtype)
    ro, rs = rssm.mlstm_block(p, x, cfg, q_chunk=q_chunk, want_state=True)
    go, gs = ssm.mlstm_block(tp, T(x), tcfg, q_chunk=q_chunk,
                             want_state=True)
    close(ro, go, tol, "parallel out")
    states_close(rs, gs, tol, "final state")
    state = {k: T(v) for k, v in rs.items()}
    xt = _x(cfg, 2, 1, 99, dtype)
    ro, rs = rssm.mlstm_block(p, xt, cfg, state=rs)
    go, back = ssm.mlstm_block(tp, T(xt), tcfg, state=state)
    assert back is state
    close(ro, go, tol, "step out")
    states_close(rs, state, tol, "step state")


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_slstm_block(prec, monkeypatch):
    """The time loop from zeros with ``want_state``, then a decode step
    from the reference's carry, the port's updated in place."""
    cfg = ref_reduced("xlstm-1.3b")
    tcfg = reduced_config("xlstm-1.3b")
    p = rssm.init_slstm(jax.random.PRNGKey(5), cfg)
    dtype = jnp.bfloat16
    if prec == "f32":
        monkeypatch.setattr(rssm, "PDTYPE", jnp.float32)
        p, dtype = _to32(p), jnp.float32
    tp = {k: T(v) for k, v in p.items()}
    tol = BLOCK_TOL if prec == "bf16" else F32_TOL
    x = _x(cfg, 2, 13, 6, dtype)
    ro, rs = rssm.slstm_block(p, x, cfg, want_state=True)
    go, gs = ssm.slstm_block(tp, T(x), tcfg, want_state=True)
    close(ro, go, tol, "out")
    states_close(rs, gs, tol, "final carry")
    state = {k: T(v) for k, v in rs.items()}
    xt = _x(cfg, 2, 1, 7, dtype)
    ro, rs = rssm.slstm_block(p, xt, cfg, state=rs)
    go, back = ssm.slstm_block(tp, T(xt), tcfg, state=state)
    assert back is state
    close(ro, go, tol, "step out")
    states_close(rs, state, tol, "step carry")


# ---------------------------------------------------------------------------
# Whole models: forward (train mode), prefill, a chain of decode steps
# ---------------------------------------------------------------------------


def _model_run(arch, dtype):
    """Both packages over one batch: the train-mode forward's logits of 20
    tokens, ``prefill`` of the first 12 (logits and cache), then 8 decode
    steps from the reference's prefilled cache (carried over by
    ``state_from_reference``), each package from its own state after
    that.  Returns {name: (ref, port)}."""
    cfg, tcfg = ref_reduced(arch), reduced_config(arch)
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    cdt = jnp.bfloat16
    if dtype == "f32":
        params, cdt = _to32(params), jnp.float32
    tp = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                               device="cpu")
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (2, 20))
    out = {}
    y, _, _ = rtf.forward(params, rtf.embed_inputs(
        params, {"tokens": jnp.asarray(toks)}, cfg), cfg, mode="train")
    ty, none = tf.forward(tp, tf.embed_inputs(tp, torch.as_tensor(toks)),
                          tcfg, mode="train")
    assert none is None
    out["forward"] = (rly.logits_fn(params, y, cfg),
                      ly.logits_fn(tp, ty, tcfg))
    rl, rc = rtf.prefill(params, {"tokens": jnp.asarray(toks[:, :12])}, cfg)
    tl, tc = tf.prefill(tp, torch.as_tensor(toks[:, :12]), tcfg)
    out["prefill logits"] = (rl, tl)
    out["prefill cache"] = (rc, tc)
    # the reference's prefilled state in a slot cache of 24 rows
    slot = rtf.init_cache(cfg, 2, 24, dtype=cdt)
    slot = jax.tree.map(
        lambda c, b: jax.lax.dynamic_update_slice(
            c, b.astype(c.dtype), (0,) * c.ndim), slot, rc)
    tslot = bridge.state_from_reference(jax.tree.map(np.asarray, slot),
                                        device="cpu")
    addrs = []
    tf.tree_map(lambda t: addrs.append(t.data_ptr()), tslot)
    index = np.full((2,), 12, np.int32)
    for t in range(12, 20):
        rl, slot = rtf.decode_step(params, slot, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.asarray(index), cfg)
        tl, back = tf.decode_step(tp, tslot, torch.as_tensor(
            toks[:, t:t + 1]), torch.as_tensor(index), tcfg)
        assert back is tslot
        out[f"decode {t}"] = (rl, tl)
        index = index + 1
    after = []
    tf.tree_map(lambda t: after.append(t.data_ptr()), tslot)
    assert after == addrs                     # updated in place
    out["decode cache"] = (slot, tslot)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_models_f32_equal_the_reference(arch, f32):
    for name, (ref, got) in _model_run(arch, "f32").items():
        if "cache" in name:
            states_close(ref, got, F32_TOL, f"{arch} {name}")
        else:
            close(ref, got, F32_TOL, f"{arch} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_models_bf16_within_model_tol(arch):
    for name, (ref, got) in _model_run(arch, "bf16").items():
        if "cache" not in name:
            close(ref, got, MODEL_TOL[arch], f"{arch} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_entry_points_refuse_recurrent_families(arch):
    cfg = reduced_config(arch)
    with pytest.raises(ValueError, match="attention family"):
        tf.init_paged_cache(cfg, 4, 8, "cpu")
    params = tf.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="kv-cache family"):
        tf.forward(params, torch.zeros((1, 4, cfg.d_model),
                                       dtype=torch.bfloat16), cfg,
                   mode="chunk")
    with pytest.raises(ValueError, match="init_paged_cache"):
        tf.init_cache(dataclasses.replace(cfg, family="dense"), 1, 8, "cpu")
