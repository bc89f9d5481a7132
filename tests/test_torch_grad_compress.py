"""Port parity: FCS gradient compression (``repro_torch.train.grad_compress``)
against ``repro.train.grad_compress``.

The port draws its hashes from a ``torch.Generator`` and the reference
from ``jax.random``, so every comparison feeds both the reference's own
``_codec_hashes`` tables.  The leaf functions work on a stacked leaf's
per-layer pieces; the cases below have rows of k that straddle two
pieces and a padded tail, and a chunk size cut small so that chunks
straddle rows too.

Tolerances.
  * ``sketch_leaf``: the same f32 terms added into the same buckets,
    perhaps in another order: rtol 1e-6 and atol 1e-6 x max |sketch|.
  * ``unsketch_leaf`` given the same sketch: bitwise (a gather and a
    product by +-1).
  * The compressed train step (a yi-9b config widened to d_model 128,
    d_ff 256, where five leaves reach 64Ki elements): the loss rtol 1e-3
    and each gradient leaf, compressed or not, within 6% of max |ref|
    with cosine >= 0.999, as tests/test_torch_train.py's uncompressed
    gradients (the round trip is linear, so the packages' bf16 gradient
    gap passes through it at about its own size).
  * The reference's statistical tests on the port's own hashes, with
    their bounds: the mean of 48 estimates within 0.85 relative error
    and correlation > 0.75 of g; 1200 compressed SGD steps reach 0.1
    relative error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.models import transformer as rtf
from repro.train import grad_compress as rgc
from repro_torch.configs.registry import ARCH_IDS, reduced_config
from repro_torch.models import bridge
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import grad_compress as gc
from repro_torch.train.loop import train

torch.set_num_threads(1)

GRAD_TOL = 0.06
WIDE = dict(d_model=128, d_ff=256)


def _wide(cfg):
    return dataclasses.replace(cfg, **WIDE)


def _ref_tables(c, key):
    """The reference's hashes of codec ``c`` under ``key``, as the port's
    tables."""
    h1, s1, h2, s2 = rgc._codec_hashes(rgc.LeafCodec(*c), key)
    return tuple(bridge.to_torch(np.asarray(t), "cpu")
                 for t in (h1, s1, h2, s2))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_codecs_equal_the_references(arch):
    for cfg, tcfg in ((ref_reduced(arch), reduced_config(arch)),
                      (_wide(ref_reduced(arch)), _wide(reduced_config(arch)))):
        params = jax.eval_shape(
            lambda: rtf.init_params(jax.random.PRNGKey(0), cfg))
        _, ref = rgc._leaf_codecs(params, 16, 0)
        got = gc._leaf_codecs(tf.init_params(tcfg, seed=0, device="cpu"), 16)
        assert [None if c is None else tuple(c) for c in got] == \
            [None if c is None else tuple(c) for c in ref]


# (pieces, per-piece shape, k): rows of 16 straddle the 37- and
# 36-element pieces; 3 x 37 = 111 leaves a padded tail of 1
LEAVES = {"padded": (3, (37,), 16), "straddling": (4, (6, 6), 16),
          "one_piece": (1, (40, 8), 8)}


@pytest.mark.parametrize("chunk", [1 << 24, 10])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_sketch_and_unsketch_leaf_match_reference(monkeypatch, leaf, chunk):
    monkeypatch.setattr(gc, "CHUNK", chunk)
    L, shape, k = LEAVES[leaf]
    rng = np.random.RandomState(len(leaf))
    g = rng.randn(L, *shape).astype(np.float32)
    n = g.size
    I1 = -(-n // k)
    c = gc.LeafCodec(3, I1, k, I1 + k - 1, I1 * k - n)
    key = jax.random.PRNGKey(11)
    ref_sk = np.asarray(rgc.sketch_leaf(jnp.asarray(g), rgc.LeafCodec(*c),
                                        key))
    tables = _ref_tables(c, key)
    pieces = [torch.as_tensor(g[i]) for i in range(L)]
    sk = gc.sketch_leaf(pieces, c, tables)
    assert sk.shape == (c.Jt,)
    np.testing.assert_allclose(sk.numpy(), ref_sk, rtol=1e-6,
                               atol=1e-6 * np.abs(ref_sk).max())
    ref_est = np.asarray(rgc.unsketch_leaf(jnp.asarray(ref_sk),
                                           rgc.LeafCodec(*c), g.shape,
                                           jnp.float32, key))
    est = gc.unsketch_leaf(torch.as_tensor(ref_sk.copy()), c, tables,
                           pieces)
    np.testing.assert_array_equal(torch.stack(est).numpy(), ref_est)
    # the round trip in place, in the gradient's dtype
    gb = [p.to(torch.bfloat16) for p in pieces]
    ref_b, _ = rgc.compress_roundtrip(
        jnp.asarray(g, jnp.bfloat16), jnp.zeros((1,)), rgc.LeafCodec(*c),
        key)
    sk_b = gc.compress_roundtrip(gb, c, tables)
    assert all(p.dtype == torch.bfloat16 for p in gb)
    want = np.asarray(rgc.unsketch_leaf(jnp.asarray(sk_b.numpy()),
                                        rgc.LeafCodec(*c), g.shape,
                                        jnp.bfloat16, key).astype(
        jnp.float32))
    np.testing.assert_array_equal(torch.stack(gb).float().numpy(), want)
    np.testing.assert_allclose(
        torch.stack(gb).float().numpy(),
        np.asarray(ref_b.astype(jnp.float32)), rtol=2 ** -7,
        atol=1e-6 * np.abs(ref_sk).max())


def test_compressed_train_step_matches_reference():
    cfg, tcfg = _wide(ref_reduced("yi-9b")), _wide(reduced_config("yi-9b"))
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    codecs = gc._leaf_codecs(tparams, cfg.sketch.grad_hash_ratio)
    names = [n for n, _ in tf.param_leaves(tparams)]
    squeezed = [n for n, c in zip(names, codecs) if c is not None]
    assert len(squeezed) >= 2, squeezed
    assert any(n.startswith("blocks/") for n in squeezed), squeezed
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :16].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    step = 5
    ef = rgc.init_error_feedback(params, cfg.sketch.grad_hash_ratio)
    loss, grads, ef = rgc.make_compressed_train_step(cfg)(
        params, ef, {k: jnp.asarray(v) for k, v in batch.items()}, step)
    tstep = gc.make_compressed_train_step(
        tcfg, hashes=lambda c, s, dev: _ref_tables(c, jax.random.fold_in(
            jax.random.PRNGKey(cfg.sketch.seed), s)))
    tef = gc.init_error_feedback(tparams)
    tloss, tgrads, tef2 = tstep(
        tparams, tef, {k: torch.as_tensor(v).long()
                       for k, v in batch.items()}, step)
    assert tef2 is tef and len(tef) == len(names)
    assert all(e.shape == (1,) and float(e.abs().max()) == 0 for e in tef)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-3)
    _, raw = jax.value_and_grad(rtf.loss_fn)(params, {
        k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    ref_flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    raw_flat = jax.tree.leaves(raw)
    for (path, r), rr, (name, pieces), c in zip(
            ref_flat, raw_flat, tf.param_leaves(tgrads), codecs):
        assert "/".join(str(getattr(p, "key", p)) for p in path) == name
        r = np.asarray(r.astype(jnp.float32))
        if c is not None:      # the estimate is not the raw gradient
            assert np.abs(r - np.asarray(rr.astype(jnp.float32))).max() > 0
        got = (torch.stack([p.float() for p in pieces]).numpy()
               if name.startswith("blocks/") else pieces[0].float().numpy())
        np.testing.assert_allclose(got, r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=name)
        cos = (got * r).sum() / (np.linalg.norm(got) * np.linalg.norm(r))
        assert cos >= 0.999, (name, cos)


def test_hashes_are_fresh_per_step_and_leaf_and_reproducible():
    c = gc.LeafCodec(2, 4096, 16, 4096 + 15, 0)
    a = gc.codec_hashes(c, 1234, 7, torch.device("cpu"))
    b = gc.codec_hashes(c, 1234, 7, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for other in (gc.codec_hashes(c, 1234, 8, torch.device("cpu")),
                  gc.codec_hashes(c._replace(leaf_id=3), 1234, 7,
                                  torch.device("cpu"))):
        assert not torch.equal(a[0], other[0])
    h1, s1, h2, s2 = a
    assert h1.dtype == torch.int32 and int(h1.min()) >= 0 \
        and int(h1.max()) < c.I1
    assert int(h2.max()) < c.k and set(s1.unique().tolist()) == {-1.0, 1.0}


def test_grad_compression_unbiased():
    """tests/test_train.py's unbiasedness test on the port's hashes."""
    g = torch.as_tensor(np.random.RandomState(0).randn(1 << 16)
                        .astype(np.float32))
    (c,) = gc._leaf_codecs({"g": g}, 16)
    assert isinstance(c, gc.LeafCodec)
    sk = gc.sketch_leaf([g], c, gc.codec_hashes(c, 0, 0, g.device))
    assert sk.shape[0] == c.Jt
    assert g.numel() / sk.numel() > 12
    acc = torch.zeros_like(g)
    n = 48
    for t in range(n):
        gh = g.clone()
        gc.compress_roundtrip([gh], c, gc.codec_hashes(c, 0, t, g.device))
        acc += gh
    est = acc / n
    err = float(torch.linalg.norm(est - g) / torch.linalg.norm(g))
    assert err < 0.85, err
    corr = float(est @ g / (torch.linalg.norm(est) * torch.linalg.norm(g)))
    assert corr > 0.75, corr


def test_compressed_sgd_converges():
    """tests/test_train.py's compressed-SGD test on the port's hashes:
    lr ~ 1 / (1 + omega), omega ~ the ratio's collision variance."""
    dim = 1 << 16
    target = torch.as_tensor(np.random.RandomState(1).randn(dim)
                             .astype(np.float32))
    x = torch.zeros(dim)
    (c,) = gc._leaf_codecs({"x": x}, 32)
    for t in range(1200):
        g = x - target
        gc.compress_roundtrip([g], c, gc.codec_hashes(c, 1, t, g.device))
        x -= (0.5 / 32) * g
    rel = float(torch.linalg.norm(x - target) / torch.linalg.norm(target))
    assert rel < 0.1, rel


def test_compressed_resume_is_bitwise(tmp_path):
    """A run with compression and sketched AdamW, crashed after its step-4
    checkpoint and resumed, continues the uninterrupted run's losses bit
    for bit: the hashes are regenerated from (seed, step, leaf), and the
    error-feedback state is checkpointed."""
    cfg = _wide(reduced_config("gemma-2b"))
    cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(
        cfg.sketch, grad_compression=True, opt_state_ratio=4,
        opt_state_min_elems=4096))
    logs = []
    run = dict(steps=7, batch=2, seq=16, lr=1e-3, log_every=1000,
               device="cpu")
    full = train(cfg, log_fn=logs.append, **run)
    assert any("[grad-compress]" in ln and not ln.startswith(
        "[grad-compress] 0 ") for ln in logs), logs
    d = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="injected crash at step 5"):
        train(cfg, ckpt_dir=d, ckpt_every=2, crash_at_step=5,
              log_fn=lambda *_: None, **run)
    assert ckpt.latest_step(d) == 4
    with open(f"{d}/ckpt_00000004.json") as f:
        assert '"ef/0"' in f.read()
    resumed = train(cfg, ckpt_dir=d, ckpt_every=100, resume=True,
                    log_fn=lambda *_: None, **run)
    assert len(resumed.losses) == 3
    np.testing.assert_array_equal(resumed.losses, full.losses[4:])


def test_trainer_learns_compressed():
    """tests/test_train.py's compressed trainer test, at the width where
    leaves compress (ratio 8): 120 steps lower the loss by more than
    0.2."""
    cfg = _wide(reduced_config("yi-9b"))
    cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(
        cfg.sketch, grad_compression=True, grad_hash_ratio=8))
    logs = []
    h = train(cfg, steps=120, batch=8, seq=64, lr=1e-2, log_every=1000,
              log_fn=logs.append, device="cpu")
    assert logs[0].startswith("[grad-compress] 5 of 12 leaves"), logs[0]
    assert h.losses[-1] < h.losses[0] - 0.2, (h.losses[0], h.losses[-1])
