"""Port parity: the dense model of ``repro_torch`` against the JAX
package on reduced gemma-2b (MQA, gelu, tied head) and yi-9b (GQA, silu),
with the reference's own parameters carried across by models/bridge.py.

Tolerances.  The bridge is exact (bitwise).  Layer-0 pool rows are
bitwise too: they depend only on the embedding, one norm and one
projection.  Everything downstream is bf16 activations whose matmuls the
two frameworks sum in different orders, so a value can round one bf16
ulp (2^-8 relative) apart and the difference propagates: across seeds
the measured gap is at most ~1% of the largest |pool value| and ~2% of
the largest |logit|.  The asserts allow 2% and 3%, and greedy argmax
must agree wherever the reference's top-1 margin exceeds twice the
allowed logit gap."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.models import layers as rly
from repro.models import transformer as rtf
from repro_torch.configs.registry import reduced_config
from repro_torch.models import bridge
from repro_torch.models import layers as ly
from repro_torch.models import transformer as tf

# tiny tensors: one intra-op thread keeps the pytest-xdist workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ARCHS = ["gemma-2b", "yi-9b"]
LOGIT_TOL = 0.03      # fraction of max |reference logit|
POOL_TOL = 0.02       # fraction of max |reference pool value|
NB, BS, NBS = 16, 8, 6


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    cfg, tcfg = ref_reduced(arch), reduced_config(arch)
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
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
    np.testing.assert_array_equal(
        tparams["embed"].view(torch.int16).numpy(),
        np.asarray(params["embed"]).view(np.int16))
    assert (tparams["head"] is None) == (params["head"] is None)
    for i, blk in enumerate(tparams["blocks"]):
        for group in ("attn", "ffn"):
            for name, w in blk[group].items():
                np.testing.assert_array_equal(
                    w.view(torch.int16).numpy(),
                    np.asarray(params["blocks"][group][name][i]).view(
                        np.int16), err_msg=f"{group}.{name}[{i}]")


def test_forward_matches_reference(models):
    cfg, params, tcfg, tparams = models
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 20))
    y, _, _ = rtf.forward(params, rtf.embed_inputs(
        params, {"tokens": jnp.asarray(toks, jnp.int32)}, cfg), cfg,
        mode="train")
    ty, _ = tf.forward(tparams, tf.embed_inputs(tparams, torch.as_tensor(
        toks)), tcfg, mode="train")
    _assert_logits_close(rly.logits_fn(params, y, cfg),
                         ly.logits_fn(tparams, ty, tcfg))


@pytest.fixture(scope="module")
def prefilled(models):
    """Three 8-token chunks of one prompt through both packages' paged
    prefill, into a table with live and dead entries."""
    cfg, params, tcfg, tparams = models
    rng = np.random.RandomState(2)
    table = np.full((NBS,), NB, np.int32)
    table[:4] = [3, 7, 1, 9]
    prompt = rng.randint(0, cfg.vocab_size, (1, 24)).astype(np.int32)
    rc = rtf.init_paged_cache(cfg, NB, BS)
    tc = tf.init_paged_cache(tcfg, NB, BS, device="cpu")
    for off in (0, 8, 16):
        chunk = prompt[:, off:off + 8]
        rc = rtf.prefill_chunk(params, rc, jnp.asarray(chunk),
                               jnp.asarray(table), jnp.int32(off), cfg,
                               kernels=False)
        tc = tf.prefill_chunk(tparams, tc, torch.as_tensor(chunk),
                              torch.as_tensor(table), off, tcfg)
    return rc, tc, table, rng


def test_prefill_chunk_pool_matches_reference(prefilled):
    rc, tc, _, _ = prefilled
    for kv in ("k", "v"):
        ref = np.asarray(rc["kv"][kv].astype(jnp.float32))
        got = tc["kv"][kv][:, :NB].float().numpy()   # drop the write sink
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=POOL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("ref_kernels", [False, True])
def test_decode_step_logits_match_reference(models, prefilled,
                                           ref_kernels):
    """Decode for three slots at mixed positions — one over the prefilled
    table, one fresh, one idle (all-dead row) — against the reference's
    gather path (False) and its Pallas kernel in interpret mode (True)."""
    cfg, params, tcfg, tparams = models
    rc, tc, table, _ = prefilled
    tc = {"kv": {k: v.clone() for k, v in tc["kv"].items()}}  # in place
    rng = np.random.RandomState(3)
    tables = np.full((3, NBS), NB, np.int32)
    tables[0], tables[1, :2] = table, [4, 5]
    idx = np.array([24, 5, 0], np.int32)
    cur = rng.randint(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    lg, rc2 = rtf.decode_step(params, rc, jnp.asarray(cur), jnp.asarray(idx),
                              cfg, tables=jnp.asarray(tables),
                              kernels=ref_kernels)
    tlg, tc2 = tf.decode_step(tparams, tc, torch.as_tensor(cur),
                              torch.as_tensor(idx), tcfg,
                              torch.as_tensor(tables))
    _assert_logits_close(np.asarray(lg)[:2], tlg.numpy()[:2])
    # the new rows landed where the reference put them; the idle slot's
    # write went to the sink and left every live block untouched
    ref_k = np.asarray(rc2["kv"]["k"].astype(jnp.float32))
    got_k = tc2["kv"]["k"][:, :NB].float().numpy()
    np.testing.assert_allclose(got_k, ref_k, rtol=0,
                               atol=POOL_TOL * np.abs(ref_k).max())


def test_init_params_seeded_and_shaped(models):
    cfg, params, tcfg, _ = models
    a = tf.init_params(tcfg, seed=3, device="cpu")
    b = tf.init_params(tcfg, seed=3, device="cpu")
    ref_shapes = {k: v.shape[1:] for k, v in
                  params["blocks"]["attn"].items()}
    assert len(a["blocks"]) == cfg.num_layers
    for name, w in a["blocks"][0]["attn"].items():
        assert tuple(w.shape) == tuple(ref_shapes[name])
        assert w.dtype == torch.bfloat16
        torch.testing.assert_close(w, b["blocks"][0]["attn"][name], rtol=0,
                                   atol=0)
    assert tuple(a["embed"].shape) == tuple(params["embed"].shape)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = reduced_config("gemma-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_paged_cache(cfg, 4, 8)


def test_unported_families_name_the_roadmap():
    # every family serves and trains since the recurrent families'
    # training was ported (tests/test_torch_train_families.py): their
    # loss is finite; and since speculation on the moe family was ported
    # (ROADMAP Queue 1 #20), nothing raises naming a ROADMAP item
    from repro_torch.serve.scheduler import SlotScheduler
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64),
             "labels": torch.zeros((1, 4), dtype=torch.int64)}
    for arch in ("xlstm-1.3b", "zamba2-2.7b"):
        cfg = reduced_config(arch)
        params = tf.init_params(cfg, seed=0, device="cpu")
        with torch.no_grad():
            assert torch.isfinite(tf.loss_fn(params, batch, cfg))
    cfg = reduced_config("deepseek-moe-16b")
    serve = dataclasses.replace(cfg.serve, max_batch=2, max_seq=64, spec_k=2)
    sched = SlotScheduler(cfg, tf.init_params(cfg, seed=0, device="cpu"),
                          serve=serve, device="cpu")
    assert sched.spec_max == 2 and sched.draft is not None
