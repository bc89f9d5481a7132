"""Port parity: the training path of ``repro_torch`` against the JAX
package on reduced yi-9b (GQA, silu, untied head) and gemma-2b (MQA,
gelu, tied head), with the reference's own parameters carried across by
models/bridge.py and the same numpy batches and gradients fed to both.

Tolerances.
  * Loss: rtol 1e-3.  Activations are bf16 and the two frameworks round
    matmul sums in different orders; across 3 seeds per arch the loss
    gap was at most 2e-4 relative.
  * Gradients (bf16): per leaf, max |port - ref| <= 6% of max |ref| and
    cosine >= 0.999.  The measured worst gap over 3 seeds per arch was
    3.6% of max |ref|: one bf16 ulp (2^-8 relative) of an activation
    propagates through the backward.
  * Optimizer, given identical gradients: moments and tables are f32
    sums of the same terms, rtol 1e-5 and atol 1e-5 x max |table|; the
    params are bf16 after each step, so a last-bit rounding of the f32
    update may differ: rtol 2^-7 (one bf16 ulp) and atol 2^-9 x
    max |leaf|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.models import layers as rly
from repro.models import model as RM
from repro.models import transformer as rtf
from repro.sketch import optimizer as rsk
from repro.train import optimizer as ropt
from repro_torch.configs.registry import reduced_config
from repro_torch.launch import train as launch_train
from repro_torch.models import bridge
from repro_torch.models import layers as ly
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.sketch import optimizer as sk
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import train

# tiny tensors: one intra-op thread keeps the pytest-xdist workers from
# oversubscribing the CPU
torch.set_num_threads(1)

LOSS_RTOL = 1e-3
GRAD_TOL = 0.06
MIN_ELEMS = 4096      # sketches blocks/attn/wk (2 x 2048): pieces < leaf
SEED = 1234           # cfg.sketch.seed
quiet = dict(log_every=1000, log_fn=lambda *_: None, device="cpu")


def _models(arch, seed=0):
    cfg, tcfg = ref_reduced(arch), reduced_config(arch)
    params = rtf.init_params(jax.random.PRNGKey(seed), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return cfg, params, tcfg, tparams


def _batch(cfg, seed, B=2, S=16):
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               (B, S + 1))
    return toks[:, :S].astype(np.int32), toks[:, 1:].astype(np.int32)


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


def _assert_params_close(ref_params, tparams):
    ref = _ref_leaves(ref_params)
    port = tf.param_leaves(tparams)
    assert [n for n, _ in ref] == [n for n, _ in port]
    for (name, r), (_, pieces) in zip(ref, port):
        np.testing.assert_allclose(_stacked(pieces, name), r, rtol=2 ** -7,
                                   atol=2 ** -9 * np.abs(r).max(),
                                   err_msg=name)


def _random_grads(params, rng):
    """One random gradient per reference leaf, in the leaf's dtype (a
    reference tree; ``bridge.from_reference`` gives the port's layout)."""
    return jax.tree.map(lambda p: jnp.asarray(
        rng.randn(*p.shape).astype(np.float32)).astype(p.dtype), params)


@pytest.mark.parametrize("arch", ["yi-9b", "gemma-2b"])
def test_param_leaves_follow_reference_order(arch):
    cfg, params, tcfg, tparams = _models(arch)
    ref = [(n, a.shape) for n, a in _ref_leaves(params)]
    port = [(n, tuple(_stacked(p, n).shape))
            for n, p in tf.param_leaves(tparams)]
    assert port == ref
    assert ("head" in dict(port)) == (not cfg.tie_embeddings)


def test_cross_entropy_matches_reference():
    """Chunks of 200 over a 512-column head: the reference pads its last
    chunk and masks the padding, the port's last chunk is narrower."""
    cfg, params, tcfg, tparams = _models("yi-9b", seed=3)
    rng = np.random.RandomState(3)
    y = rng.randn(2, 16, cfg.d_model).astype(np.float32)
    _, labels = _batch(cfg, 4)
    want = rly.cross_entropy(params, jnp.asarray(y, jnp.bfloat16),
                             jnp.asarray(labels), cfg, vocab_chunk=200)
    got = ly.cross_entropy(tparams, torch.as_tensor(y).to(torch.bfloat16),
                           torch.as_tensor(labels).long(), tcfg,
                           vocab_chunk=200)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    full = ly.cross_entropy(tparams, torch.as_tensor(y).to(torch.bfloat16),
                            torch.as_tensor(labels).long(), tcfg)
    np.testing.assert_allclose(float(full), float(got), rtol=1e-5)


@pytest.mark.parametrize("arch", ["yi-9b", "gemma-2b"])
def test_loss_and_grads_match_reference(arch):
    cfg, params, tcfg, tparams = _models(arch, seed=1)
    toks, labels = _batch(cfg, 1)
    loss, grads = RM.make_train_step(cfg)(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tloss, tgrads = M.make_train_step(tcfg)(
        tparams, {"tokens": torch.as_tensor(toks).long(),
                  "labels": torch.as_tensor(labels).long()})
    np.testing.assert_allclose(float(tloss), float(loss), rtol=LOSS_RTOL)
    assert not any(p.requires_grad for _, ps in tf.param_leaves(tparams)
                   for p in ps)
    for (name, r), (pname, pieces) in zip(_ref_leaves(grads),
                                          tf.param_leaves(tgrads)):
        assert name == pname
        assert all(p.dtype == torch.bfloat16 for p in pieces)
        g = _stacked(pieces, name)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=name)
        cos = (g * r).sum() / (np.linalg.norm(g) * np.linalg.norm(r))
        assert cos >= 0.999, (name, cos)


def _ref_optimizer(kind, params):
    if kind == "dense":
        return (ropt.adamw_init(params),
                lambda g, s, p: ropt.adamw_update(g, s, p, lr=1e-2))
    return (rsk.sketched_adamw_init(params, ratio=4, rows=3,
                                    min_elems=MIN_ELEMS, seed=SEED),
            lambda g, s, p: rsk.sketched_adamw_update(g, s, p, lr=1e-2))


def _port_optimizer(kind, tparams):
    if kind == "dense":
        return (opt.adamw_init(tparams),
                lambda g, s, p: opt.adamw_update(g, s, p, lr=1e-2))
    return (sk.sketched_adamw_init(tparams, ratio=4, rows=3,
                                   min_elems=MIN_ELEMS, seed=SEED),
            lambda g, s, p: sk.sketched_adamw_update(g, s, p, lr=1e-2))


def _assert_state_close(ref_state, state, tcfg):
    ported = bridge.opt_state_from_reference(
        jax.tree.map(np.asarray, ref_state), tcfg, device="cpu")
    assert ported.step == state.step
    if isinstance(state, opt.AdamWState):
        pairs = [(a, b) for x, y in ((ported.m, state.m),
                                     (ported.v, state.v))
                 for (_, a), (_, b) in zip(tf.param_leaves(x),
                                           tf.param_leaves(y))]
        pairs = [(torch.stack(a), torch.stack(b)) for a, b in pairs]
    else:
        pairs = []
        for a, b in zip(ported.moments, state.moments):
            assert type(a) is type(b)
            if isinstance(a, sk.SketchedMoments):
                assert (a.m.seed, a.v.seed, a.m.d) == (b.m.seed, b.v.seed,
                                                       b.m.d)
                torch.testing.assert_close(a.m.coeffs, b.m.coeffs, rtol=0,
                                           atol=0)
                pairs += [(a.m.table, b.m.table), (a.v.table, b.v.table)]
            else:
                pairs += [(torch.stack(a.m), torch.stack(b.m)),
                          (torch.stack(a.v), torch.stack(b.v))]
    for want, got in pairs:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("kind", ["dense", "sketched"])
def test_optimizer_matches_reference(kind):
    """Three steps from identical gradients: params, moments and tables
    track the reference's after every step."""
    cfg, params, tcfg, tparams = _models("yi-9b", seed=2)
    rstate, rupdate = _ref_optimizer(kind, params)
    state, update = _port_optimizer(kind, tparams)
    if kind == "sketched":
        kinds = [type(m).__name__ for m in state.moments]
        names = [n for n, _ in tf.param_leaves(tparams)]
        assert kinds[names.index("blocks/attn/wk")] == "SketchedMoments"
        assert kinds[names.index("blocks/norm1")] == "DenseMoments"
        ref_b = rsk.moment_state_bytes(rstate)
        assert sk.moment_state_bytes(state) == ref_b
    rng = np.random.RandomState(5)
    for _ in range(3):
        g = _random_grads(params, rng)
        params, rstate = rupdate(g, rstate, params)
        tg = bridge.from_reference(jax.tree.map(np.asarray, g), tcfg,
                                   device="cpu")
        tparams, state = update(tg, state, tparams)
        _assert_params_close(params, tparams)
        _assert_state_close(rstate, state, tcfg)


def test_sgd_matches_reference():
    cfg, params, tcfg, tparams = _models("gemma-2b", seed=6)
    g = _random_grads(params, np.random.RandomState(6))
    want = ropt.sgd_update(g, params, lr=1e-2)
    got = opt.sgd_update(bridge.from_reference(
        jax.tree.map(np.asarray, g), tcfg, device="cpu"), tparams, lr=1e-2)
    _assert_params_close(want, got)


@pytest.mark.parametrize("kind", ["dense", "sketched"])
def test_carried_state_continues_reference(kind):
    """The reference trains 2 steps; its params and optimizer state are
    carried into the port, whose step 3 equals the reference's."""
    cfg, params, tcfg, _ = _models("yi-9b", seed=4)
    rstate, rupdate = _ref_optimizer(kind, params)
    step = RM.make_train_step(cfg)
    for s in range(3):
        toks, labels = _batch(cfg, 10 + s)
        _, g = step(params, {"tokens": jnp.asarray(toks),
                             "labels": jnp.asarray(labels)})
        if s == 2:
            tparams = bridge.from_reference(jax.tree.map(np.asarray, params),
                                            tcfg, device="cpu")
            state = bridge.opt_state_from_reference(
                jax.tree.map(np.asarray, rstate), tcfg, device="cpu")
            assert state.step == 2
            _, update = _port_optimizer(kind, tparams)
            tg = bridge.from_reference(jax.tree.map(np.asarray, g), tcfg,
                                       device="cpu")
            tparams, state = update(tg, state, tparams)
        params, rstate = rupdate(g, rstate, params)
    _assert_params_close(params, tparams)
    _assert_state_close(rstate, state, tcfg)


def test_trainer_learns():
    """As the reference's tests/test_train.py: 120 steps of reduced yi-9b
    lower the loss by more than 0.3, here with sketched AdamW."""
    cfg = reduced_config("yi-9b")
    cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(
        cfg.sketch, opt_state_ratio=4, opt_state_min_elems=MIN_ELEMS))
    h = train(cfg, steps=120, batch=8, seq=64, lr=1e-2, **quiet)
    assert all(np.isfinite(h.losses))
    assert h.losses[-1] < h.losses[0] - 0.3, (h.losses[0], h.losses[-1])


def test_resume_after_crash_is_bitwise(tmp_path):
    cfg = reduced_config("gemma-2b")
    cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(
        cfg.sketch, opt_state_ratio=4, opt_state_min_elems=MIN_ELEMS))
    d = str(tmp_path / "run")
    run = dict(steps=12, batch=2, seq=32, lr=1e-3, **quiet)
    full = train(cfg, **run)
    with pytest.raises(RuntimeError, match="injected crash at step 9"):
        train(cfg, ckpt_dir=d, ckpt_every=6, crash_at_step=9, **run)
    assert ckpt.latest_step(d) == 6
    resumed = train(cfg, ckpt_dir=d, ckpt_every=100, resume=True, **run)
    assert len(resumed.losses) == 6
    np.testing.assert_array_equal(resumed.losses, full.losses[6:])


def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    cfg, _, tcfg, tparams = _models("yi-9b")
    state = {"params": tparams,
             "opt": sk.sketched_adamw_init(tparams, ratio=4,
                                           min_elems=MIN_ELEMS)}
    state["opt"].step = 7
    rng = np.random.RandomState(0)
    for mo in state["opt"].moments:
        for t in ([mo.m.table, mo.v.table] if hasattr(mo.m, "table")
                  else mo.m + mo.v):
            t.copy_(torch.as_tensor(rng.randn(*t.shape)))
    ckpt.save(str(tmp_path), 3, state)
    like = {"params": tf.tree_map(torch.zeros_like, tparams),
            "opt": sk.sketched_adamw_init(tparams, ratio=4,
                                          min_elems=MIN_ELEMS)}
    step, got = ckpt.restore(str(tmp_path), like)
    assert step == 3 and got["opt"].step == 7
    a, b = ckpt._leaves(state), ckpt._leaves(got)
    assert [n for n, _, _ in a] == [n for n, _, _ in b]
    for (n, x, _), (_, y, _) in zip(a, b):
        if isinstance(x, int):
            assert x == y, n
        else:
            assert x.dtype == y.dtype, n
            assert torch.equal(x, y), n


def test_data_is_stateless_and_learnable():
    cfg = reduced_config("yi-9b")
    a = data_lib.make_batch(cfg, 7, 4, 32, seed=3, device="cpu")
    b = data_lib.make_batch(cfg, 7, 4, 32, seed=3, device="cpu")
    c = data_lib.make_batch(cfg, 8, 4, 32, seed=3, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    t = a["tokens"]
    assert t.shape == (4, 32) and int(t.min()) >= 0 \
        and int(t.max()) < cfg.vocab_size
    periodic = (t[:, 8:] == t[:, :-8]).float().mean().item()
    assert periodic > 0.6           # motifs of 8 with 10% noise


def test_train_raises_for_what_is_not_ported():
    cfg = reduced_config("yi-9b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train(cfg, steps=1, batch=1, seq=8, grad_compression=True, **quiet)


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    assert launch_train.parse_args([]).device is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1", "--batch", "1", "--seq", "8"])
    hist = launch_train.main(["--device", "cpu", "--steps", "2", "--batch",
                              "2", "--seq", "16", "--opt-state-ratio", "4",
                              "--opt-state-min-elems", "4096"])
    assert len(hist.losses) == 2 and all(np.isfinite(hist.losses))
