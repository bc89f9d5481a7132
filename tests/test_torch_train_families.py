"""Port parity: training every family of ``repro_torch`` against the JAX
package on the reduced configs, with the reference's own parameters
carried across by models/bridge.py and the same numpy batches fed to
both: the moe family (granite-moe-3b-a800m, deepseek-moe-16b; cross
entropy plus the router's aux loss), the frontend stubs' ``embeds``
batches (musicgen-medium, internvl2-2b), and the recurrent families
(xlstm-1.3b, zamba2-2.7b) through their recurrences; then ``train()``
for every config, and one sketched-AdamW step of each new family.

Tolerances.
  * bf16 gradients (moe, audio, vlm): per leaf, max |port - ref| <=
    ``GRAD_TOL`` (6%) of max |ref| and cosine >= 0.999, as
    tests/test_torch_train.py (one bf16 ulp of an activation through the
    backward).  Loss: rtol ``LOSS_RTOL`` (1e-3).  The moe family's
    routing is tracked as tests/test_torch_moe_serve.py:Routes tracks
    it: the top-k of every MoE call of the reference's own gradient
    computation is recorded by an ordered debug callback (its compiled
    forward may route a near-tie apart from an eager run of it), and
    the port runs on that routing (forced through models/routing.py, in
    the forward and in each block's recompute), so no row routes apart
    between the two gradients; every row the forcing changed must be a
    near-tie of the port's own routing (``ROUTER_TIE``, 0.02 router
    logits, as tests/test_torch_moe.py).  On a flipped row both
    gradients are right and far apart.  The aux loss alone: rtol
    ``AUX_RTOL`` (1e-3: past the first layer the router sees bf16
    inputs rounded apart; measured up to 2.4e-4); its gradient into the
    router: ``AUX_GRAD_TOL`` of max |ref| and cosine >= 0.999.
  * f32 gradients (ssm, hybrid): both packages in f32 (the reference's
    ``PDTYPE`` patched, f32 weights): per leaf, max |port - ref| <=
    ``F32_GRAD_TOL`` (1e-3) of max |ref| (f32 rounding of sums added in
    other orders through the recurrences).  bf16 losses within
    ``BF16_LOSS_RTOL`` (5%): a random reduced xLSTM's bf16 logits sit
    15-49% from its f32 ones (tests/test_torch_ssm.py), the mean cross
    entropy much less.
  * Optimizer tables from identical gradients: rtol 1e-5 and atol 1e-5
    x max |table|; params one bf16 ulp (tests/test_torch_train.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.models import layers as rly
from repro.models import ssm as rssm
from repro.models import transformer as rtf
from repro.sketch import optimizer as rsk
from repro.train import data as rdata
from repro_torch.configs.registry import ARCH_IDS, reduced_config
from repro_torch.models import bridge
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.routing import RoutingProbe
from repro_torch.sketch import optimizer as sk
from repro_torch.train import data as data_lib
from repro_torch.train.loop import train

torch.set_num_threads(1)

LOSS_RTOL = 1e-3
GRAD_TOL = 0.06
AUX_RTOL = 1e-3
AUX_GRAD_TOL = 0.02
F32_GRAD_TOL = 1e-3
BF16_LOSS_RTOL = 0.05
ROUTER_TIE = 0.02       # router logits, as tests/test_torch_moe.py
MIN_ELEMS = 4096
SEED = 1234
MOE = ["granite-moe-3b-a800m", "deepseek-moe-16b"]
STUBS = ["musicgen-medium", "internvl2-2b"]
RECURRENT = ["xlstm-1.3b", "zamba2-2.7b"]
quiet = dict(log_every=1000, log_fn=lambda *_: None, device="cpu")


def _models(arch, seed=0, f32=False):
    cfg, tcfg = ref_reduced(arch), reduced_config(arch)
    params = rtf.init_params(jax.random.PRNGKey(seed), cfg)
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return cfg, params, tcfg, tparams


def _tokens(cfg, seed, B=2, S=16):
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               (B, S + 1))
    return toks[:, :S].astype(np.int32), toks[:, 1:].astype(np.int32)


def _batches(cfg, seed, B=2, S=16, embeds=False):
    """The same batch for both packages: (reference's, port's)."""
    toks, labels = _tokens(cfg, seed, B, S)
    ref = {"labels": jnp.asarray(labels)}
    port = {"labels": torch.as_tensor(labels).long()}
    if embeds:
        e = np.random.RandomState(seed + 1).randn(B, S, cfg.d_model)
        ref["embeds"] = jnp.asarray(e, jnp.bfloat16)
        port["embeds"] = bridge.to_torch(np.asarray(ref["embeds"]), "cpu")
    else:
        ref["tokens"] = jnp.asarray(toks)
        port["tokens"] = torch.as_tensor(toks).long()
    return ref, port


def _stacked(pieces, name):
    if name.startswith("blocks/"):
        return torch.stack([p.float() for p in pieces]).numpy()
    return pieces[0].float().numpy()


def _ref_leaves(tree):
    """(name, numpy f32) in the reference's flatten order."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out.append((name, np.asarray(leaf.astype(jnp.float32))))
    return out


def _assert_grads_close(grads, tgrads, tol, cos_min=None):
    ref = _ref_leaves(grads)
    port = tf.param_leaves(tgrads)
    assert [n for n, _ in ref] == [n for n, _ in port]
    for (name, r), (_, pieces) in zip(ref, port):
        g = _stacked(pieces, name)
        assert g.shape == r.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * np.abs(r).max(),
                                   err_msg=name)
        if cos_min is not None and np.abs(r).max() > 0:
            cos = (g * r).sum() / (np.linalg.norm(g) * np.linalg.norm(r))
            assert cos >= cos_min, (name, cos)


def _both_grads(cfg, params, tcfg, tparams, batch, tbatch):
    loss, grads = jax.value_and_grad(rtf.loss_fn)(params, batch, cfg)
    tloss, tgrads = M.make_train_step(tcfg)(tparams, tbatch)
    return float(loss), grads, float(tloss), tgrads


# ---------------------------------------------------------------------------
# moe: cross entropy plus the router's aux loss
# ---------------------------------------------------------------------------


def _reference_routed(monkeypatch, cfg, run):
    """``run()`` (reference code, compiled as it runs) with the top-k of
    every MoE call recorded by an ordered debug callback, as
    tests/test_torch_moe_serve.py:Routes records a served stream: the
    reference's gradient routes as its compiled forward does, which may
    differ at a near-tie from an eager run of it.  The backward's
    recompute (``jax.checkpoint``) must route as the forward.  Returns
    (result, forcing {layer: topi (G, g, K)} for the port)."""
    seen = []
    top_k = jax.lax.top_k

    def recording(a, k):
        out = top_k(a, k)
        jax.debug.callback(
            lambda t: seen.append(np.array(t).reshape(-1, k)), out[1],
            ordered=True)
        return out

    jax.clear_caches()          # no trace without the callback is reused
    monkeypatch.setattr(jax.lax, "top_k", recording)
    try:
        res = run()
        jax.effects_barrier()
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    L, m = cfg.num_layers, cfg.moe
    assert len(seen) in (L, 2 * L)
    for a, b in zip(seen[:L], seen[L:][::-1]):
        np.testing.assert_array_equal(a, b)
    T = len(seen[0])
    g = min(m.group_size, T)
    return res, {layer: torch.as_tensor(a).long().reshape(T // g, g, m.top_k)
                 for layer, a in enumerate(seen[:L])}


def _port_aux(tcfg, tparams, tbatch, forcing):
    """The port's aux loss on the forcing, and how far the forcing is
    from the port's own routing: (aux, rows it changed, worst gap in
    router logits)."""
    with RoutingProbe({k: [v] for k, v in forcing.items()}) as probe, \
            torch.no_grad():
        _, aux = tf._train_forward(tparams, tf.embed_inputs(tparams, tbatch),
                                   tcfg)
    return float(aux), probe.differ, probe.worst


def _ref_loss_and_aux(cfg, batch):
    """The reference's ``loss_fn``, its aux term beside it."""
    def fn(p):
        y, aux, _ = rtf.forward(p, rtf.embed_inputs(p, batch, cfg), cfg,
                                mode="train")
        return rly.cross_entropy(p, y, batch["labels"], cfg) + aux, aux
    return fn


@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_and_grads_match_reference(monkeypatch, arch):
    """Loss, aux and every gradient leaf on the reference's routing: the
    port forced onto the experts the reference's gradient computation
    chose, in the forward and in each block's recompute."""
    cfg, params, tcfg, tparams = _models(arch, seed=1)
    batch, tbatch = _batches(cfg, 1, B=2, S=24)
    ((loss, raux), grads), forcing = _reference_routed(
        monkeypatch, cfg, lambda: jax.value_and_grad(
            _ref_loss_and_aux(cfg, batch), has_aux=True)(params))
    taux, _, worst = _port_aux(tcfg, tparams, tbatch, forcing)
    assert worst < ROUTER_TIE, worst
    assert float(raux) > 0
    np.testing.assert_allclose(taux, float(raux), rtol=AUX_RTOL)
    with RoutingProbe({k: [v, v] for k, v in forcing.items()}) as probe:
        tloss, tgrads = M.make_train_step(tcfg)(tparams, tbatch)
    assert len(probe.calls) == 2 * cfg.num_layers     # forward, recompute
    np.testing.assert_allclose(float(tloss), float(loss), rtol=LOSS_RTOL)
    _assert_grads_close(grads, tgrads, GRAD_TOL, cos_min=0.999)
    names = [n for n, _ in tf.param_leaves(tgrads)]
    router = tf.param_leaves(tgrads)[names.index("blocks/moe/router")][1]
    assert all(r.dtype == torch.float32 and r.abs().max() > 0
               for r in router)


@pytest.mark.parametrize("arch", MOE)
def test_moe_aux_gradient_into_the_router(monkeypatch, arch):
    """The aux term alone, differentiated on the reference's routing: its
    gradient reaches every router through the mean probabilities (the
    one-hot fractions are constant), and through the hidden state every
    earlier layer."""
    cfg, params, tcfg, tparams = _models(arch, seed=2)
    batch, tbatch = _batches(cfg, 2, B=2, S=24)
    aux_only = lambda p: _ref_loss_and_aux(cfg, batch)(p)[1]
    rgrad, forcing = _reference_routed(
        monkeypatch, cfg, lambda: jax.grad(aux_only)(params))
    assert _port_aux(tcfg, tparams, tbatch, forcing)[2] < ROUTER_TIE
    routers = [blk["moe"]["router"] for blk in tparams["blocks"]]
    for r in routers:
        r.requires_grad_(True)
    try:
        with RoutingProbe({k: [v, v] for k, v in forcing.items()}):
            _, taux = tf._train_forward(
                tparams, tf.embed_inputs(tparams, tbatch), tcfg)
            tgrad = torch.autograd.grad(taux, routers)
    finally:
        for r in routers:
            r.requires_grad_(False)
    r = np.asarray(rgrad["blocks"]["moe"]["router"])
    g = torch.stack(tgrad).numpy()
    assert np.abs(r).max() > 0
    np.testing.assert_allclose(g, r, rtol=0,
                               atol=AUX_GRAD_TOL * np.abs(r).max())
    assert (g * r).sum() / (np.linalg.norm(g) * np.linalg.norm(r)) >= 0.999


def test_moe_drops_contribute_nothing_backward():
    """A capacity that drops choices: a token none of whose choices was
    kept gets exactly zero from the experts, and its output row sends no
    gradient into any expert weight or the router."""
    tcfg = reduced_config("granite-moe-3b-a800m")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.25))
    params = tf.init_params(tcfg, seed=4, device="cpu")
    p = params["blocks"][0]["moe"]
    x = torch.randn((2, 16, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(4)).to(torch.bfloat16)
    with RoutingProbe() as probe, torch.no_grad():
        moe.moe_ffn(p, x, tcfg)
    keep = probe.calls[0].keep
    assert not bool(keep.all()) and bool(keep.any())
    none_kept = ~keep.any(-1).reshape(-1)[:32]
    assert none_kept.any()
    leaves = list(p.values())
    for t in leaves:
        t.requires_grad_(True)
    try:
        y, aux = moe.moe_ffn(p, x, tcfg, with_aux=True)
        rows = y.reshape(32, -1)[none_kept].float()
        assert float(rows.detach().abs().max()) == 0.0
        grads = torch.autograd.grad(rows.sum(), leaves, allow_unused=True,
                                    retain_graph=True)
        assert all(g is None or float(g.abs().max()) == 0.0 for g in grads)
        grads = torch.autograd.grad(y.float().square().sum() + aux, leaves)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
    finally:
        for t in leaves:
            t.requires_grad_(False)


# ---------------------------------------------------------------------------
# audio and vlm: the frontend stubs' embeds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", STUBS)
def test_embeds_batches_match_reference(arch):
    cfg, params, tcfg, tparams = _models(arch, seed=3)
    batch, tbatch = _batches(cfg, 3, embeds=True)
    loss, grads, tloss, tgrads = _both_grads(cfg, params, tcfg, tparams,
                                             batch, tbatch)
    np.testing.assert_allclose(tloss, loss, rtol=LOSS_RTOL)
    _assert_grads_close(grads, tgrads, GRAD_TOL, cos_min=0.999)
    # the embedding table is not read: zero gradient in both
    names = [n for n, _ in tf.param_leaves(tgrads)]
    emb = tf.param_leaves(tgrads)[names.index("embed")][1][0]
    assert float(emb.abs().max()) == 0.0


@pytest.mark.parametrize("arch", STUBS)
def test_stub_batches_are_the_references_shape(arch):
    """make_batch gives {"embeds", "labels"}: the stub table's rows of
    token % 1024, the same table every step (seeded from seed + 1)."""
    tcfg = reduced_config(arch)
    a = data_lib.make_batch(tcfg, 3, 2, 16, seed=5, device="cpu")
    b = data_lib.make_batch(tcfg, 4, 2, 16, seed=5, device="cpu")
    assert set(a) == {"embeds", "labels"}
    assert a["embeds"].shape == (2, 16, tcfg.d_model)
    assert a["embeds"].dtype == torch.bfloat16
    table = data_lib.stub_table(tcfg, 5)
    for bt in (a, b):
        rows = {tuple(r.tolist()) for r in table.float()}
        assert all(tuple(e.tolist()) in rows
                   for e in bt["embeds"].float().reshape(-1, tcfg.d_model))
    ref = ref_reduced(arch)
    rb = rdata.make_batch(ref, 3, 2, 16, seed=5)
    assert set(rb) == set(a)
    assert rb["embeds"].shape == a["embeds"].shape
    assert str(rb["embeds"].dtype) == "bfloat16"


# ---------------------------------------------------------------------------
# ssm and hybrid: gradients through the recurrences
# ---------------------------------------------------------------------------


@pytest.fixture
def f32(monkeypatch):
    """The reference computing in f32: its bf16 casts patched to f32."""
    monkeypatch.setattr(rly, "PDTYPE", jnp.float32)
    monkeypatch.setattr(rssm, "PDTYPE", jnp.float32)


@pytest.mark.parametrize("S", [16, 520])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_grads_f32_match_reference(arch, S, f32):
    """S 520 passes the mLSTM's query chunk of 512 (a second, padded
    chunk in the reference) and spans nine zamba2 SSD chunks of 64."""
    cfg, params, tcfg, tparams = _models(arch, seed=5, f32=True)
    batch, tbatch = _batches(cfg, 5, B=2 if S == 16 else 1, S=S)
    loss, grads, tloss, tgrads = _both_grads(cfg, params, tcfg, tparams,
                                             batch, tbatch)
    np.testing.assert_allclose(tloss, loss, rtol=1e-5)
    _assert_grads_close(grads, tgrads, F32_GRAD_TOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_bf16_loss_within_tolerance(arch):
    cfg, params, tcfg, tparams = _models(arch, seed=6)
    batch, tbatch = _batches(cfg, 6)
    loss, _, tloss, tgrads = _both_grads(cfg, params, tcfg, tparams, batch,
                                         tbatch)
    np.testing.assert_allclose(tloss, loss, rtol=BF16_LOSS_RTOL)
    assert all(torch.isfinite(p).all() for _, ps in tf.param_leaves(tgrads)
               for p in ps)


def test_mlstm_block_grads_across_query_chunks(f32):
    """One mLSTM block at q_chunk 8 over 20 tokens (three chunks, the last
    short), f32: input and parameter gradients against the reference's."""
    from repro_torch.models import ssm
    cfg, params, tcfg, tparams = _models("xlstm-1.3b", seed=7, f32=True)
    p = jax.tree.map(lambda a: a[0], params["blocks"]["mlstm"])
    tp = tparams["blocks"]["mlstm"][0]
    x = np.random.RandomState(7).randn(2, 20, cfg.d_model).astype(np.float32)
    w = np.random.RandomState(8).randn(2, 20, cfg.d_model).astype(np.float32)

    def ref(p, x):
        out, _ = rssm.mlstm_block(p, x, cfg, q_chunk=8)
        return jnp.sum(out * w)

    rgp, rgx = jax.grad(ref, argnums=(0, 1))(p, jnp.asarray(x))
    tx = torch.as_tensor(x).requires_grad_(True)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    out, _ = ssm.mlstm_block(leaves, tx, tcfg, q_chunk=8)
    grads = torch.autograd.grad((out * torch.as_tensor(w)).sum(),
                                [tx, *leaves.values()])
    for v in leaves.values():
        v.requires_grad_(False)
    for name, g in zip(["x", *leaves], grads):
        r = np.asarray(rgx if name == "x" else rgp[name])
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=F32_GRAD_TOL * np.abs(r).max(),
                                   err_msg=name)


def test_train_mode_runs_no_in_place_state_update(monkeypatch):
    """The decode-only in-place updates (the conv buffers', the mLSTM's
    and Mamba-2's state's, the sLSTM's copy back) never run in training:
    a backward through every family would raise or read an overwritten
    tensor otherwise."""
    from repro_torch.models import ssm
    calls = []
    real = ssm._conv_step
    monkeypatch.setattr(ssm, "_conv_step",
                        lambda *a: calls.append(1) or real(*a))
    for arch in RECURRENT:
        tcfg = reduced_config(arch)
        params = tf.init_params(tcfg, seed=0, device="cpu")
        b = data_lib.make_batch(tcfg, 0, 2, 8, device="cpu")
        loss, grads = M.make_train_step(tcfg)(params, b)
        assert torch.isfinite(loss)
    assert calls == []


# ---------------------------------------------------------------------------
# the trainer, every config; one sketched-AdamW step of each new family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_runs_every_config(arch):
    tcfg = reduced_config(arch)
    tcfg = dataclasses.replace(tcfg, sketch=dataclasses.replace(
        tcfg.sketch, opt_state_ratio=4, opt_state_min_elems=MIN_ELEMS))
    h = train(tcfg, steps=2, batch=2, seq=16, lr=1e-3, **quiet)
    assert len(h.losses) == 2 and all(np.isfinite(h.losses))


@pytest.mark.parametrize("arch", MOE + STUBS + RECURRENT)
def test_sketched_adamw_step_matches_reference(arch):
    """One sketched-AdamW step (ratio 4, rows 3) from the same random
    gradients: every table, dense moment and param of the family's
    leaves against the reference's."""
    cfg, params, tcfg, tparams = _models(arch, seed=9)
    rstate = rsk.sketched_adamw_init(params, ratio=4, rows=3,
                                     min_elems=MIN_ELEMS, seed=SEED)
    state = sk.sketched_adamw_init(tparams, ratio=4, rows=3,
                                   min_elems=MIN_ELEMS, seed=SEED)
    assert sk.moment_state_bytes(state) == rsk.moment_state_bytes(rstate)
    rng = np.random.RandomState(9)
    g = jax.tree.map(lambda p: jnp.asarray(
        rng.randn(*p.shape).astype(np.float32)).astype(p.dtype), params)
    params, rstate = rsk.sketched_adamw_update(g, rstate, params, lr=1e-2)
    tg = bridge.from_reference(jax.tree.map(np.asarray, g), tcfg,
                               device="cpu")
    tparams, state = sk.sketched_adamw_update(tg, state, tparams, lr=1e-2)
    ported = bridge.opt_state_from_reference(
        jax.tree.map(np.asarray, rstate), tcfg, device="cpu")
    n_sketched = 0
    for a, b in zip(ported.moments, state.moments):
        assert type(a) is type(b)
        if isinstance(a, sk.SketchedMoments):
            n_sketched += 1
            pairs = [(a.m.table, b.m.table), (a.v.table, b.v.table)]
        else:
            pairs = [(torch.stack(a.m), torch.stack(b.m)),
                     (torch.stack(a.v), torch.stack(b.v))]
        for want, got in pairs:
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * want.abs().max().item())
    assert n_sketched >= 3
    for (name, r), (_, pieces) in zip(_ref_leaves(params),
                                      tf.param_leaves(tparams)):
        np.testing.assert_allclose(_stacked(pieces, name), r, rtol=2 ** -7,
                                   atol=2 ** -9 * np.abs(r).max(),
                                   err_msg=name)
