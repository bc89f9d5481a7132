"""The port on the card: the sm_90a paged-attention and sketch_update
kernels against their plain versions, the model's kernel path against its
plain path, the slot engine launching the paged-attention kernel, and
the sketched optimizer launching sketch_update.  Every test carries the
``cuda`` marker and skips without a card; the file imports nothing of
JAX, so it runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import reduced_config
from repro_torch.kernels import ref
from repro_torch.kernels.ops import sketch_update_op
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.sketch_update import sketch_update
from repro_torch.models import transformer as tf
from repro_torch.serve.scheduler import Request, SlotScheduler
from repro_torch.sketch.hashing import cached_coeffs
from repro_torch.sketch.optimizer import (sketched_adamw_init,
                                          sketched_adamw_update)

pytestmark = pytest.mark.cuda

# (B, Sq, K, R, hd, NB, bs, nb): decode, multi-query, chunked prefill,
# R == 1, and gemma-2b's serve geometry (decode and prefill chunk)
SHAPES = [
    (3, 1, 2, 3, 16, 12, 8, 4),
    (2, 4, 2, 2, 32, 10, 4, 5),
    (1, 16, 1, 4, 16, 8, 8, 6),
    (4, 3, 3, 1, 8, 20, 16, 3),
    (8, 1, 1, 8, 256, 256, 16, 32),
    (1, 32, 1, 8, 256, 256, 16, 32),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(B, Sq, K, R, hd, NB, bs, nb, dev, seed=0):
    """Ragged geometry as in tests/test_kernels.py: per-slot starts, slot
    0's last table entry invalidated, fold_base mixing 0 and bs."""
    rng = np.random.RandomState(seed)
    bf = [torch.tensor(rng.randn(*s), dtype=torch.bfloat16, device=dev)
          for s in ((B, Sq, K, R, hd), (NB, bs, K, hd), (NB, bs, K, hd))]
    tables = (rng.permutation(NB)[:B * nb].reshape(B, nb) if B * nb <= NB
              else rng.randint(0, NB, (B, nb))).astype(np.int32)
    tables[0, nb - 1] = NB
    start = rng.randint(0, nb * bs - Sq, (B,)).astype(np.int32)
    fb = np.minimum(np.array([0] * (B - B // 2) + [bs] * (B // 2),
                             np.int32), start)
    return bf + [torch.as_tensor(a, device=dev) for a in (tables, start, fb)]


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(card, shape):
    """m at rtol 1e-5 and l at rtol 1e-4 (f32 sums in another order);
    acc/l at atol 2e-2, since one bf16 rounding of p may differ."""
    args = _inputs(*shape, card, seed=9)
    before = paged_attention.launches
    m, l, acc = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    mr, lr, ar = ref.paged_attention_ref(*args)
    torch.testing.assert_close(m, mr, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(l, lr, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(acc / l.clamp(min=1e-30)[..., None],
                               ar / lr.clamp(min=1e-30)[..., None],
                               rtol=0, atol=2e-2)


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    args = _inputs(*SHAPES[0], card)
    bad = list(args)
    bad[1] = args[1].float()
    with pytest.raises(ValueError, match="bfloat16"):
        paged_attention(*bad)
    bad = list(args)
    bad[3] = args[3].long()
    with pytest.raises(ValueError, match="int32"):
        paged_attention(*bad)
    bad = list(args)
    bad[1] = args[1].transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(*bad)


def test_decode_logits_kernel_vs_plain(card):
    """Reduced gemma-2b decode on the card: the kernel path against the
    plain path on identical caches (3% of max|logit|, as the CPU model
    parity tests)."""
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, seed=1, device=card)
    NB, bs, nbs = 16, 8, 6
    cache = tf.init_paged_cache(cfg, NB, bs, card)
    tables = torch.full((3, nbs), NB, dtype=torch.int32, device=card)
    tables[0, :4] = torch.tensor([3, 7, 1, 9], dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (1, 24), device=card,
                           generator=torch.Generator(card).manual_seed(0))
    for off in (0, 8, 16):
        tf.prefill_chunk(params, cache, prompt[:, off:off + 8], tables[0],
                         off, cfg)
    pos = torch.tensor([24, 0, 0], dtype=torch.int32, device=card)
    cur = torch.tensor([[5], [6], [7]], device=card)
    clone = lambda c: {"kv": {k: v.clone() for k, v in c["kv"].items()}}
    lk, _ = tf.decode_step(params, clone(cache), cur, pos, cfg, tables)
    lp, _ = tf.decode_step(params, clone(cache), cur, pos, cfg, tables,
                           kernels=False)
    torch.testing.assert_close(lk, lp, rtol=0,
                               atol=0.03 * lp.abs().max().item())


def test_engine_launches_the_kernel(card):
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, seed=2, device=card)
    serve = dataclasses.replace(cfg.serve, max_batch=2, max_seq=64,
                                prefill_bucket=16)
    sched = SlotScheduler(cfg, params, serve=serve, device=card)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, tokens=rng.randint(0, 512, 20).astype(np.int32),
                    max_new=6, temperature=0.8 * (i % 2), top_k=8, seed=i)
            for i in range(4)]
    before = paged_attention.launches
    done = sched.run(reqs)
    assert paged_attention.launches > before
    assert sorted(c.rid for c in done) == [0, 1, 2, 3]
    assert all(len(c.tokens) == 6 for c in done)
    assert sched.alloc.reserved == sched.prefix_cache.held_blocks()


def _sketch_inputs(n, C, R, offset, dtype, dev, pieces=1):
    rng = np.random.RandomState(n % 1000)
    g = torch.tensor(rng.randn(n), dtype=dtype, device=dev)
    mt = torch.tensor(rng.randn(R, C), dtype=torch.float32, device=dev)
    vt = torch.tensor(np.abs(rng.randn(R, C)), dtype=torch.float32,
                      device=dev)
    cm = cached_coeffs(n + 3, R, device=dev)
    cv = cached_coeffs(n + 4, R, device=dev)
    cuts = np.linspace(0, n, pieces + 1).astype(int)
    parts = [(g[a:b], offset + int(a)) for a, b in zip(cuts, cuts[1:])]
    return g, parts, mt, vt, cm, cv


# (n, C, R, offset, dtype, pieces): the reference's four kernel shapes
# (tests/test_sketch_opt.py), a bf16 gradient at an offset past 2^31
# (a yi-9b FFN leaf's last layers), and three pieces of one vector
SKETCH_SHAPES = [
    (1000, 300, 3, 0, torch.float32, 1),
    (4096, 512, 3, 0, torch.float32, 1),
    (700, 128, 4, 0, torch.float32, 1),
    (8192, 640, 2, 0, torch.float32, 1),
    (50_000, 4096, 3, 2_119_172_096, torch.bfloat16, 1),
    (30_000, 2048, 3, 7, torch.float32, 3),
]


@pytest.mark.parametrize("shape", SKETCH_SHAPES)
def test_sketch_update_kernel_matches_plain_version(card, shape):
    """Tables and estimates within rtol 1e-5 and atol 1e-5 x max|table|:
    f32 atomics add in a varying order, and the kernel scales each term
    where the plain version scales the sum."""
    n, C, R, offset, dtype, npieces = shape
    g, parts, mt, vt, cm, cv = _sketch_inputs(n, C, R, offset, dtype, card,
                                              npieces)
    km, kv = mt.clone(), vt.clone()
    before = sketch_update.launches
    est = list(sketch_update(parts, km, kv, cm, cv, b1=0.9, b2=0.95))
    torch.cuda.synchronize()
    assert sketch_update.launches == before + 1 + 2 * npieces
    new_m, new_v = ref.sketch_accumulate_ref(parts, mt, vt, cm, cv, 0.9,
                                             0.95)
    for got, want in ((km, new_m), (kv, new_v)):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
    for (gp, off), (m_hat, v_hat) in zip(parts, est):
        rm, rv = ref.sketch_retrieve_ref(gp.numel(), off, new_m, new_v, cm,
                                         cv)
        torch.testing.assert_close(m_hat, rm, rtol=1e-5,
                                   atol=1e-5 * new_m.abs().max().item())
        torch.testing.assert_close(v_hat, rv, rtol=1e-5,
                                   atol=1e-5 * new_v.abs().max().item())


def test_sketched_optimizer_launches_the_kernel(card):
    """Reduced yi-9b, sketched AdamW: one step on the card launches
    sketch_update and matches the plain path's step (params within one
    bf16 ulp, tables as above)."""
    cfg = reduced_config("yi-9b")
    params = tf.init_params(cfg, seed=3, device=card)
    gen = torch.Generator(card).manual_seed(4)
    grads = tf.tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=card).to(p.dtype), params)
    clone = lambda t: tf.tree_map(torch.clone, t)
    p_k, p_r = clone(params), clone(params)
    s_k = sketched_adamw_init(p_k, ratio=4, rows=3, min_elems=4096)
    s_r = sketched_adamw_init(p_r, ratio=4, rows=3, min_elems=4096)
    before = sketch_update.launches
    sketched_adamw_update(grads, s_k, p_k, lr=1e-2)
    assert sketch_update.launches > before
    sketched_adamw_update(grads, s_r, p_r, lr=1e-2, use_kernel=False)
    for (_, a), (_, b) in zip(tf.param_leaves(p_k), tf.param_leaves(p_r)):
        for x, y in zip(a, b):
            torch.testing.assert_close(x.float(), y.float(), rtol=2 ** -7,
                                       atol=1e-6)
    for a, b in zip(s_k.moments, s_r.moments):
        if hasattr(a.m, "table"):
            for x, y in ((a.m.table, b.m.table), (a.v.table, b.v.table)):
                torch.testing.assert_close(
                    x, y, rtol=1e-5, atol=1e-5 * y.abs().max().item())


def test_sketch_update_op_sends_cuda_tensors_to_the_kernel(card):
    g, parts, mt, vt, cm, cv = _sketch_inputs(512, 128, 3, 0, torch.float32,
                                              card)
    before = sketch_update.launches
    list(sketch_update_op(parts, mt, vt, cm, cv, b1=0.9, b2=0.95))
    assert sketch_update.launches == before + 3
    with pytest.raises(ValueError, match="float32"):
        sketch_update(parts, mt.double(), vt, cm, cv, b1=0.9, b2=0.95)
