"""The port on the card: the sm_90a paged-attention kernel against its
plain version, the model's kernel path against its plain path, and the
slot engine launching the kernel.  Every test carries the ``cuda`` marker
and skips without a card; the file imports nothing of JAX, so it runs on
the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import reduced_config
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import transformer as tf
from repro_torch.serve.scheduler import Request, SlotScheduler

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
