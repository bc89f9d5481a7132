"""Port parity: training attention at the reference's context lengths.

The port's ``causal_attention`` is the reference's ``causal_attention`` +
``_flash_attention``: an online softmax over KV chunks of ``kv_chunk``
(keys padded to a whole chunk, f32 running max, sum and accumulator),
each chunk's body recomputed in the backward.  Held here on the CPU:

  * against the reference's function, on reduced yi-9b's attention
    block (4 query heads, 2 KV heads, head dim 16), at S 1, 700 and
    2500 and at ``kv_chunk`` 1024 and 64 (a ragged last chunk), in f32
    and in bf16: outputs, and the gradients of x and of every weight
    for a seeded cotangent (autograd against ``jax.grad``);
  * against a dense S x S f32 oracle kept in this file;
  * one layer's forward at S 4096 keeps O(S * kv_chunk) bytes for its
    backward (the dense form keeps the S x S probabilities);
  * reduced gemma-2b, yi-9b and zamba2-2.7b train steps at S 1100 (two
    chunks of 1024, the second ragged): loss and gradients against the
    reference's, from its parameters through ``bridge.from_reference``.

Tolerances (fractions of max |reference|, measured at most ~1/5 of
them).  f32: outputs ``F32_TOL`` (1e-5), gradients ``F32_GRAD_TOL``
(1e-4); both packages sum the same chunks in other orders.  bf16:
outputs ``BF16_TOL`` (1e-2) and gradients ``BF16_GRAD_TOL`` (3e-2): a
score, a probability or a product may round one bf16 ulp (2^-8
relative) apart and the backward carries it.  Train steps run in f32
(the reference's ``PDTYPE`` patched, f32 weights): loss rtol 1e-5,
gradients ``F32_STEP_TOL`` (1e-3) of max |ref| per leaf, as
tests/test_torch_train_families.py holds the recurrent families.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.models import layers as rly
from repro.models import ssm as rssm
from repro.models import transformer as rtf
from repro_torch.configs.registry import reduced_config
from repro_torch.launch.cost_analysis import CostMode
from repro_torch.models import bridge
from repro_torch.models import layers as ly
from repro_torch.models import model as M
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

F32_TOL = 1e-5
F32_GRAD_TOL = 1e-4
BF16_TOL = 1e-2
BF16_GRAD_TOL = 3e-2
F32_STEP_TOL = 1e-3
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _block(arch, prec, seed=0):
    """(reference config, its layer-0 attention params, port config, the
    port's copy of them) in ``prec``."""
    cfg, tcfg = ref_reduced(arch), reduced_config(arch)
    params = rtf.init_params(jax.random.PRNGKey(seed), cfg)
    jdt, tdt = DTYPES[prec]
    pa = jax.tree.map(lambda a: a[0].astype(jdt), params["blocks"]["attn"])
    tpa = {k: bridge.to_torch(np.asarray(v), "cpu").to(tdt)
           for k, v in pa.items()}
    return cfg, pa, tcfg, tpa


def _dense_attention(p, x, cfg):
    """The dense oracle: the port's projections, then one f32 softmax
    over the whole (B, H, S, S) masked score tensor."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    q, k, v = ly._project_qkv_rope(p, x, cfg, torch.arange(S))
    k = k.repeat_interleave(H // K, dim=2).float()
    v = v.repeat_interleave(H // K, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / np.sqrt(hd)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return ly.linear(o.reshape(B, S, H * hd).to(x.dtype), p["wo"])


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max()) or 1.0
    assert err <= tol * scale, f"{what}: max err {err} vs {tol} x {scale}"


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("kv_chunk", [1024, 64])
@pytest.mark.parametrize("S", [1, 700, 2500])
def test_causal_attention_matches_reference(S, kv_chunk, prec):
    cfg, pa, tcfg, tpa = _block("yi-9b", prec)
    jdt, tdt = DTYPES[prec]
    rng = np.random.RandomState(S + kv_chunk)
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    w = rng.randn(2, S, cfg.d_model).astype(np.float32)
    xr, wr = jnp.asarray(x, jdt), jnp.asarray(w, jnp.float32)

    def ref_fn(p, xx):
        o = rly.causal_attention(p, xx, cfg, jnp.arange(S), kv_chunk)
        return jnp.sum(o.astype(jnp.float32) * wr), o

    (_, ref_o), (ref_gp, ref_gx) = jax.value_and_grad(
        ref_fn, argnums=(0, 1), has_aux=True)(pa, xr)
    xt = bridge.to_torch(np.asarray(xr), "cpu").requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tpa.items()}
    o = ly.causal_attention(leaves, xt, tcfg, kv_chunk=kv_chunk)
    (o.float() * torch.as_tensor(w)).sum().backward()
    tol, gtol = ((F32_TOL, F32_GRAD_TOL) if prec == "f32"
                 else (BF16_TOL, BF16_GRAD_TOL))
    f = lambda a: np.asarray(a.astype(jnp.float32))
    _close(o.detach().float(), f(ref_o), tol, "output")
    _close(xt.grad.float(), f(ref_gx), gtol, "dx")
    for name, t in leaves.items():
        _close(t.grad.float(), f(ref_gp[name]), gtol, f"d{name}")


@pytest.mark.parametrize("kv_chunk", [1024, 64])
def test_chunked_attention_matches_the_dense_oracle(kv_chunk):
    """f32, S 700: the chunked online softmax against one softmax over
    the whole masked S x S scores, outputs and the gradient of x."""
    cfg, _, tcfg, tpa = _block("yi-9b", "f32", seed=3)
    rng = np.random.RandomState(kv_chunk)
    x = torch.as_tensor(rng.randn(1, 700, cfg.d_model).astype(np.float32))
    w = torch.as_tensor(rng.randn(1, 700, cfg.d_model).astype(np.float32))
    outs = []
    for fn in (lambda xx: ly.causal_attention(tpa, xx, tcfg, kv_chunk),
               lambda xx: _dense_attention(tpa, xx, tcfg)):
        xx = x.clone().requires_grad_(True)
        o = fn(xx)
        (o * w).sum().backward()
        outs.append((o.detach(), xx.grad))
    (o, gx), (do, dgx) = outs
    _close(o, do, F32_TOL, "output")
    _close(gx, dgx, F32_GRAD_TOL, "dx")


def _kept_bytes(fn, x):
    """Bytes the forward ``fn(x)`` leaves alive for its backward (every
    storage an op made that is still held once it returns, its output
    aside; the walk's own accounting, launch/cost_analysis.py), and the
    forward's peak."""
    cm = CostMode()
    with cm:
        o = fn(x)
    kept = cm.live - o.untyped_storage().nbytes()
    o.float().sum().backward()
    return kept, cm.peak


def test_one_layer_keeps_o_s_kc_bytes_for_its_backward():
    """Reduced yi-9b's attention at B 1, S 4096, kv_chunk 1024: the
    chunked form keeps its chunks' carries (f32 max, sum, accumulator)
    and the roped q, k, v, under one chunk's (B, H, S, kc) f32 scores;
    the dense form keeps at least the (B, H, S, S) f32 probabilities."""
    cfg, _, tcfg, tpa = _block("yi-9b", "bf16", seed=4)
    S, kc = 4096, 1024
    H = cfg.num_heads
    x = torch.randn(1, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4)).to(torch.bfloat16).requires_grad_(True)
    kept, _ = _kept_bytes(lambda t: ly.causal_attention(tpa, t, tcfg, kc), x)
    dense, _ = _kept_bytes(lambda t: _dense_attention(tpa, t, tcfg), x)
    chunk_scores = H * S * kc * 4
    assert 0 < kept <= chunk_scores, (kept, chunk_scores)
    assert dense >= H * S * S * 4, (dense, H * S * S * 4)


@pytest.fixture
def f32(monkeypatch):
    """The reference computing in f32: its bf16 casts patched to f32."""
    monkeypatch.setattr(rly, "PDTYPE", jnp.float32)
    monkeypatch.setattr(rssm, "PDTYPE", jnp.float32)


def _leaves(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out.append((name, np.asarray(leaf.astype(jnp.float32))))
    return out


@pytest.mark.parametrize("arch", ["gemma-2b", "yi-9b", "zamba2-2.7b"])
def test_train_step_at_two_chunks_matches_reference(arch, f32):
    """One sequence of 1100 tokens: the attention walks two KV chunks of
    1024 (the second padded), in every attention block (zamba2: its
    shared blocks)."""
    cfg, tcfg = ref_reduced(arch), reduced_config(arch)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          rtf.init_params(jax.random.PRNGKey(8), cfg))
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (1, 1101))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    loss, grads = jax.value_and_grad(rtf.loss_fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    tloss, tgrads = M.make_train_step(tcfg)(
        tparams, {k: torch.as_tensor(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    ref = _leaves(grads)
    port = tf.param_leaves(tgrads)
    assert [n for n, _ in ref] == [n for n, _ in port]
    for (name, r), (_, pieces) in zip(ref, port):
        g = (torch.stack([p.float() for p in pieces]).numpy()
             if name.startswith("blocks/") else pieces[0].float().numpy())
        assert g.shape == r.shape, name
        _close(g, r, F32_STEP_TOL, name)
