"""The port on the card: the sm_90a paged-attention, sketch_update,
tail_fold, tail_scores, count_sketch and unsketch kernels against their
plain versions, the model's kernel path against its plain path, the slot
engine launching the paged-attention kernel (and, sketched, the tail
kernels), the sketched optimizer launching sketch_update, and sketched
RTPM launching count_sketch and unsketch.  Every test carries the
``cuda`` marker and skips without a card; the file imports nothing of
JAX, so it runs on the card's machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import reduced_config
from repro_torch.core import make_tensor_hashes, mode_hash_from_coeffs
from repro_torch.cpd.rtpm import rtpm_decompose
from repro_torch.kernels.count_sketch import (bucket_links, count_sketch,
                                              plan, unsketch)
from repro_torch.kernels import ref
from repro_torch.kernels.kv_sketch import tail_fold, tail_scores
from repro_torch.kernels.ops import (count_sketch_op, sketch_update_op,
                                     tail_fold_op, tail_scores_op,
                                     unsketch_op)
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.sketch_update import (accumulate, entry_bytes,
                                               plan_groups, sketch_apply,
                                               sketch_update)
from repro_torch.models import transformer as tf
from repro_torch.serve.scheduler import Request, SlotScheduler
from repro_torch.sketch.hashing import cached_coeffs
from repro_torch.sketch.optimizer import (sketched_adamw_init,
                                          sketched_adamw_update)

pytestmark = pytest.mark.cuda

# (B, Sq, K, R, hd, NB, bs, nb): decode, multi-query, chunked prefill,
# R == 1, gemma-2b's serve geometry (decode and prefill chunk) and its 8k
# geometry (decode over 512 blocks a slot, a 256-token prefill chunk)
SHAPES = [
    (3, 1, 2, 3, 16, 12, 8, 4),
    (2, 4, 2, 2, 32, 10, 4, 5),
    (1, 16, 1, 4, 16, 8, 8, 6),
    (4, 3, 3, 1, 8, 20, 16, 3),
    (8, 1, 1, 8, 256, 256, 16, 32),
    (1, 32, 1, 8, 256, 256, 16, 32),
    (8, 1, 1, 8, 256, 4096, 16, 512),
    (1, 256, 1, 8, 256, 4096, 16, 512),
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
    acc/l at atol 2e-2 x min(1, max|acc/l|), since one bf16 rounding of p
    may differ, and that moves acc/l by a part of its own size (|acc/l|
    is about 0.02 at 8k context)."""
    args = _inputs(*shape, card, seed=9)
    before = paged_attention.launches
    m, l, acc = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    mr, lr, ar = ref.paged_attention_ref(*args)
    torch.testing.assert_close(m, mr, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(l, lr, rtol=1e-4, atol=1e-6)
    want = ar / lr.clamp(min=1e-30)[..., None]
    torch.testing.assert_close(acc / l.clamp(min=1e-30)[..., None], want,
                               rtol=0, atol=2e-2 * min(
                                   1.0, want.abs().max().item()))


@pytest.mark.parametrize("shape", SHAPES[:1] + SHAPES[4:])
def test_kernel_launches_agree_bitwise(card, shape):
    """No atomics: two launches on the same inputs give the same bits; a
    slot's output is bitwise unchanged when other slots' start and
    fold_base move (the split plan reads shapes only)."""
    args = _inputs(*shape, card, seed=2)
    first = paged_attention(*args)
    again = paged_attention(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    other = list(args)
    other[4] = args[4].flip(0).clone()
    other[4][0] = args[4][0]
    other[5] = torch.zeros_like(args[5])
    other[5][0] = args[5][0]
    moved = paged_attention(*other)
    torch.cuda.synchronize()
    assert all(torch.equal(a[0], b[0]) for a, b in zip(first, moved))


def test_kernel_reads_q_through_its_strides(card):
    """q as the model hands it, a view with padded strides: equal to the
    same values made contiguous."""
    args = _inputs(*SHAPES[1], card, seed=6)
    wide = torch.zeros(args[0].shape[:-1] + (48,), dtype=torch.bfloat16,
                       device=card)
    wide[..., :32] = args[0]
    view = wide[..., :32]
    assert not view.is_contiguous()
    got = paged_attention(view, *args[1:])
    want = paged_attention(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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
# (a yi-9b FFN leaf's last layers), three pieces of one vector, and a
# table row of several slabs (C past 2^15) in ragged pieces
SKETCH_SHAPES = [
    (1000, 300, 3, 0, torch.float32, 1),
    (4096, 512, 3, 0, torch.float32, 1),
    (700, 128, 4, 0, torch.float32, 1),
    (8192, 640, 2, 0, torch.float32, 1),
    (50_000, 4096, 3, 2_119_172_096, torch.bfloat16, 1),
    (30_000, 2048, 3, 7, torch.float32, 3),
    (600_000, 100_000, 3, 5, torch.bfloat16, 5),
]


def _groups(parts, R):
    return plan_groups([g.numel() for g, _ in parts], R,
                       entry_bytes(parts[0][0].dtype))


@pytest.mark.parametrize("shape", SKETCH_SHAPES)
def test_sketch_update_kernel_matches_plain_version(card, shape):
    """Tables and estimates within rtol 1e-5 and atol 1e-5 x max|table|:
    shared-memory f32 atomics add a slab's entries in a varying order,
    and the kernel scales each term where the plain version scales the
    sum.  Launches: five a group of the accumulate, one retrieve a
    piece."""
    n, C, R, offset, dtype, npieces = shape
    g, parts, mt, vt, cm, cv = _sketch_inputs(n, C, R, offset, dtype, card,
                                              npieces)
    km, kv = mt.clone(), vt.clone()
    before = sketch_update.launches
    est = list(sketch_update(parts, km, kv, cm, cv, b1=0.9, b2=0.95))
    torch.cuda.synchronize()
    assert sketch_update.launches == before + 5 * len(_groups(parts, R)) \
        + npieces
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


@pytest.mark.parametrize("shape", SKETCH_SHAPES)
def test_sketch_apply_is_the_plain_path_given_equal_tables(card, shape):
    """The fused apply: tables as the estimates form's (same tolerance),
    and, from the tables it produced, params bitwise the plain path's
    (sketch_retrieve_ref, then sketched_leaf_update) on the card."""
    n, C, R, offset, dtype, npieces = shape
    g, parts, mt, vt, cm, cv = _sketch_inputs(n, C, R, offset, dtype, card,
                                              npieces)
    rng = np.random.RandomState(7)
    params = [torch.tensor(rng.randn(gp.numel()), dtype=torch.bfloat16,
                           device=card) for gp, _ in parts]
    want = [p.clone() for p in params]
    km, kv = mt.clone(), vt.clone()
    hyper = dict(lr=1e-2, eps=1e-8, weight_decay=0.01, bc1=0.1, bc2=0.05)
    before = sketch_update.launches
    sketch_apply(parts, params, km, kv, cm, cv, b1=0.9, b2=0.95, **hyper)
    torch.cuda.synchronize()
    assert sketch_update.launches == before + 5 * len(_groups(parts, R)) + 1
    new_m, new_v = ref.sketch_accumulate_ref(parts, mt, vt, cm, cv, 0.9,
                                             0.95)
    for got, table in ((km, new_m), (kv, new_v)):
        torch.testing.assert_close(got, table, rtol=1e-5,
                                   atol=1e-5 * table.abs().max().item())
    for p, (gp, off) in zip(want, parts):
        mh, vh = ref.sketch_retrieve_ref(gp.numel(), off, km, kv, cm, cv)
        ref.sketched_leaf_update(p, mh, vh, **hyper)
    for got, p in zip(params, want):
        assert torch.equal(got, p)


def test_multi_piece_accumulate_equals_one_piece(card):
    """Five ragged pieces in one accumulate (one group of five segments)
    give the tables of the same vector as one piece, within the tables'
    tolerance (the slab adds vary in order)."""
    g, parts, mt, vt, cm, cv = _sketch_inputs(400_000, 70_000, 3, 9,
                                              torch.bfloat16, card, 5)
    am, av, bm, bv = mt.clone(), vt.clone(), mt.clone(), vt.clone()
    accumulate(parts, am, av, cm, cv, b1=0.9, b2=0.95)
    accumulate([(g, 9)], bm, bv, cm, cv, b1=0.9, b2=0.95)
    for x, y in ((am, bm), (av, bv)):
        torch.testing.assert_close(x, y, rtol=1e-5,
                                   atol=1e-5 * y.abs().max().item())


def test_accumulate_in_several_groups(card, monkeypatch):
    """A work space too small for the vector: the groups (pieces cut
    across them) give the plain version's tables, and the launches count
    five a group."""
    from repro_torch.kernels import sketch_update as su
    g, parts, mt, vt, cm, cv = _sketch_inputs(90_000, 40_000, 3, 0,
                                              torch.bfloat16, card, 2)
    monkeypatch.setattr(su, "WORKSPACE_BYTES", 20_000 * 6 * 4)
    groups = plan_groups([gp.numel() for gp, _ in parts], 3, 4,
                         su.WORKSPACE_BYTES)
    assert len(groups) == 5
    km, kv = mt.clone(), vt.clone()
    before = sketch_update.launches
    accumulate(parts, km, kv, cm, cv, b1=0.9, b2=0.95)
    assert sketch_update.launches == before + 5 * len(groups)
    new_m, new_v = ref.sketch_accumulate_ref(parts, mt, vt, cm, cv, 0.9,
                                             0.95)
    for got, want in ((km, new_m), (kv, new_v)):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


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
    assert sketch_update.launches == before + 5 + 1
    with pytest.raises(ValueError, match="float32"):
        sketch_update(parts, mt.double(), vt, cm, cv, b1=0.9, b2=0.95)


# (G, N, Z, C, D, rows dtype): reduced with even and odd row counts, then
# the gemma-2b 8k serve shapes: the decode-chunk fold (18 layers x 8 slots
# x k/v, fold_cap 32) and one slot's prefill fold-through (18 x k/v, 272)
FOLD_SHAPES = [
    (5, 24, 2, 48, 16, torch.float32),
    (3, 40, 4, 32, 40, torch.bfloat16),
    (288, 32, 3, 1024, 256, torch.bfloat16),
    (36, 272, 3, 1024, 256, torch.bfloat16),
]


def _fold_inputs(G, N, Z, C, D, dtype, dev, seed=0):
    rng = np.random.RandomState(seed)
    rows = torch.tensor(rng.randn(G, N, D), dtype=dtype, device=dev)
    base = rng.randint(0, 4096, (G, 1))
    pos = torch.tensor(base + np.arange(N)[None], dtype=torch.int32,
                       device=dev)
    counts = torch.tensor(rng.randint(0, N + 1, G), dtype=torch.int32,
                          device=dev)
    counts[0] = N
    tail = torch.tensor(rng.randn(G, Z, C, D), dtype=torch.float32,
                        device=dev)
    return rows, pos, counts, tail, cached_coeffs(seed + 7, Z, device=dev)


@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_tail_fold_kernel_is_the_rowwise_fold_bitwise(card, shape):
    """Each table element receives the same additions in the same order
    as the row-by-row fold, so the kernel equals it bitwise, and two
    launches agree.  Positions drawn from 40 values (C 32 or 48) make
    rows collide inside a tile at the reduced shapes."""
    rows, pos, counts, tail, cf = _fold_inputs(*shape, card, seed=4)
    if shape[3] < 100:
        pos = torch.randint(0, 40, pos.shape, dtype=torch.int32,
                            device=card,
                            generator=torch.Generator(card).manual_seed(1))
    got, again, want = tail.clone(), tail.clone(), tail.clone()
    tail_fold(rows, pos, counts, got, cf)
    tail_fold(rows, pos, counts, again, cf)
    ref.tail_fold_rowwise_ref(rows, pos, counts, want, cf)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", FOLD_SHAPES)
def test_tail_fold_kernel_matches_plain_version(card, shape):
    """Tables within 1e-5 x max|table|: f32 sums in another order (the
    kernel adds row by row, the plain version adds the summed delta)."""
    rows, pos, counts, tail, cf = _fold_inputs(*shape, card)
    got, want = tail.clone(), tail.clone()
    before = tail_fold.launches
    tail_fold(rows, pos, counts, got, cf)
    torch.cuda.synchronize()
    assert tail_fold.launches == before + 1
    ref.tail_fold_ref(rows, pos, counts, want, cf)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_tail_fold_kernel_on_a_strided_slot_view(card):
    """One slot's tables out of a stacked (2, L, B, Z, C, D) tensor, as
    the prefill fold-through passes them: only that slot changes."""
    rng = np.random.RandomState(3)
    L, B, Z, C, D, N = 2, 3, 3, 32, 16, 20
    full = torch.tensor(rng.randn(2, L, B, Z, C, D), dtype=torch.float32,
                        device=card)
    want = full.clone()
    rows = torch.tensor(rng.randn(2 * L, N, D), dtype=torch.bfloat16,
                        device=card)
    pos = torch.arange(N, dtype=torch.int32, device=card).repeat(2 * L, 1)
    counts = torch.full((2 * L,), N, dtype=torch.int32, device=card)
    cf = cached_coeffs(5, Z, device=card)
    tail_fold(rows, pos, counts, full[:, :, 1].view(2 * L, Z, C, D), cf)
    ref.tail_fold_ref(rows, pos, counts, want[:, :, 1].view(2 * L, Z, C, D),
                      cf)
    torch.testing.assert_close(full, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    bad = torch.zeros((2 * L, Z, D, C), device=card).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tail_fold(rows, pos, counts, bad, cf)


# (B, K, N, hd, Z, C, T): reduced with even row counts and two kv heads,
# then gemma-2b's 8k decode (8 slots x 8 query heads) and one 256-token
# prefill chunk (256 x 8 query rows)
SCORE_SHAPES = [
    (2, 2, 6, 16, 2, 48, 200),
    (3, 1, 5, 40, 4, 32, 130),
    (8, 1, 8, 256, 3, 1024, 8192),
    (1, 1, 2048, 256, 3, 1024, 8192),
    (2, 1, 16, 72, 3, 100, 300),        # the decode tile, full
    (1, 2, 17, 36, 3, 70, 300),         # the prefill tile, ragged edges
]


@pytest.mark.parametrize("shape", SCORE_SHAPES)
def test_tail_scores_kernel_matches_plain_version(card, shape):
    """Estimates within 1e-4 x max|estimate|: the bucket products sum hd
    f32 terms in another order; gathers, signs and medians are exact."""
    B, K, N, hd, Z, C, T = shape
    rng = np.random.RandomState(1)
    q = torch.tensor(rng.randn(B, K, N, hd), dtype=torch.float32,
                     device=card)
    tk = torch.tensor(rng.randn(B, Z, C, K, hd), dtype=torch.float32,
                      device=card)
    cf = cached_coeffs(11, Z, device=card)
    before = tail_scores.launches
    got = tail_scores(q, tk, cf, T)
    torch.cuda.synchronize()
    assert tail_scores.launches == before + 2
    want = ref.tail_scores_ref(q, tk, cf, T)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * want.abs().max().item())


def test_tail_ops_send_cuda_tensors_to_the_kernels(card):
    rows, pos, counts, tail, cf = _fold_inputs(*FOLD_SHAPES[0], card)
    f0, s0 = tail_fold.launches, tail_scores.launches
    tail_fold_op(rows, pos, counts, tail, cf)
    tail_scores_op(torch.zeros((1, 1, 2, 16), device=card),
                   torch.zeros((1, 2, 48, 1, 16), device=card), cf, 64)
    assert (tail_fold.launches, tail_scores.launches) == (f0 + 1, s0 + 2)
    with pytest.raises(ValueError, match="float32"):
        tail_fold(rows, pos, counts, tail.double(), cf)
    with pytest.raises(ValueError, match="16 bytes"):
        tail_fold(rows[..., :10].contiguous(), pos, counts,
                  tail[..., :10].contiguous(), cf)


# (D, B, I, J): D = 0 is one 1-D table, the reference's call.  The six
# shapes of tests/test_kernels.py, then the cpd path's: the FCS tiuu's
# count sketch of 15 inits at Fig. 1 and reduced CS-oracle shapes (B 25 in
# 8 chunks, B 1 in many); a J past the shared-memory accumulators
# (J-slabs); I neither a multiple of the tile nor of 4 (scalar loads)
CS_SHAPES = [(0, 1, 64, 32), (0, 4, 1000, 256), (0, 2, 300, 64),
             (0, 8, 4096, 512), (0, 1, 50, 300), (0, 3, 128, 128),
             (2, 15, 100, 10_000), (2, 25, 64_000, 1000),
             (2, 1, 200_000, 10_000), (2, 8, 60_000, 100_000),
             (2, 3, 5001, 300)]


def _cs_inputs(D, B, I, J, dev, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    shape = (I,) if D == 0 else (D, I)
    x = torch.randn((B, I), generator=gen, device=dev)
    h = torch.randint(0, J, shape, generator=gen, device=dev,
                      dtype=torch.int32)
    s = 1.0 - 2.0 * torch.randint(0, 2, shape, generator=gen, device=dev,
                                  dtype=torch.int32).float()
    return x, h, s


@pytest.mark.parametrize("shape", CS_SHAPES)
def test_count_sketch_kernel_matches_plain_version(card, shape):
    """Within 1e-5 x max|out| (f32 sums in another order: the plain
    version's atomics against the kernel's chains); bitwise the plain
    model of the kernel's order (``ref.count_sketch_tiled_ref``); two
    launches agree bitwise (no atomics)."""
    D, B, I, J = shape
    x, h, s = _cs_inputs(D, B, I, J, card)
    before = count_sketch.launches
    got = count_sketch(x, h, s, J)
    again = count_sketch(x, h, s, J, bucket_links(h, s, J))
    torch.cuda.synchronize()
    assert count_sketch.launches == before + 2
    want = ref.count_sketch_ref(x, h, s, J)
    assert got.shape == want.shape == ((B, J) if D == 0 else (D, B, J))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, again)
    assert torch.equal(got, ref.count_sketch_tiled_ref(x, h, s, J))


@pytest.mark.parametrize("shape", [(0, 4, 512, 128), (2, 25, 64_000, 1000),
                                   (2, 3, 5001, 300)])
def test_count_sketch_kernel_bf16(card, shape):
    """bf16 x accumulates in f32 and is written in bf16: within one bf16
    rounding (2^-7 x max|out|) of the plain version, and bitwise its
    tiled model (the same f32 sums, rounded once)."""
    D, B, I, J = shape
    x, h, s = _cs_inputs(D, B, I, J, card, seed=1)
    xb = x.to(torch.bfloat16)
    got = count_sketch(xb, h, s, J)
    assert got.dtype == torch.bfloat16
    want = ref.count_sketch_ref(xb, h, s, J)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2 ** -7 * want.float().abs().max().item())
    assert torch.equal(got, ref.count_sketch_tiled_ref(xb, h, s, J))


@pytest.mark.parametrize("shape", [(2, 4, 9000, 300), (2, 8, 60_000, 100_000)])
def test_count_sketch_kernel_ignores_entries_past_J(card, shape):
    """Entries with h >= J (in both branches) contribute nothing: the same
    as the plain version with those entries' x zeroed."""
    D, B, I, J = shape
    x, h, s = _cs_inputs(D, B, I, J, card, seed=7)
    h[:, ::7] = J + torch.arange(0, I, 7, device=card, dtype=torch.int32)
    got = count_sketch(x, h, s, J)
    keep = h < J
    want = torch.stack([ref.count_sketch_ref(x * keep[d], h[d].clamp(max=J - 1),
                                             s[d], J) for d in range(D)])
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, ref.count_sketch_tiled_ref(x, h, s, J))


# (D, B, I, J, y per repetition): the six reference shapes, the FCS
# tiuu's lookup at Fig. 1, a reduced Fig. 5 decompress, ragged I
UNSKETCH_SHAPES = [(0, 1, 64, 32, False), (0, 4, 1000, 256, False),
                   (0, 2, 300, 64, False), (0, 8, 4096, 512, False),
                   (0, 1, 50, 300, False), (0, 3, 128, 128, False),
                   (2, 15, 100, 29_998, True), (20, 1, 120_000, 60_000, True),
                   (3, 2, 500, 70, False), (3, 5, 1001, 70, True)]


@pytest.mark.parametrize("shape", UNSKETCH_SHAPES)
def test_unsketch_kernel_equals_plain_version_bitwise(card, shape):
    D, B, I, J, per_row = shape
    _, h, s = _cs_inputs(D, B, I, J, card, seed=2)
    gen = torch.Generator(card).manual_seed(3)
    y = torch.randn(((D,) if per_row else ()) + (B, J), generator=gen,
                    device=card)
    before = unsketch.launches
    got = unsketch(y, h, s)
    torch.cuda.synchronize()
    assert unsketch.launches == before + 1
    want = ref.unsketch_ref(y, h, s)
    assert got.shape == want.shape
    assert torch.equal(got, want)


def test_unsketch_kernel_bf16_and_misaligned_tables(card):
    """bf16 y (vector stores of 4 bf16) and tables at an offset that is
    not 16-byte aligned (scalar loads): bitwise the plain version, for
    B > 1 rows read from one set of tables."""
    _, h, s = _cs_inputs(3, 6, 4097, 500, card, seed=8)
    y = torch.randn((3, 6, 500), device=card).to(torch.bfloat16)
    got = unsketch(y, h[:, :4096].contiguous(), s[:, :4096].contiguous())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.unsketch_ref(y, h[:, :4096], s[:, :4096]))
    hv, sv = h.reshape(-1)[1:4097], s.reshape(-1)[1:4097]    # offset 4 B
    y2 = y[0].float().contiguous()
    assert torch.equal(unsketch(y2, hv, sv), ref.unsketch_ref(y2, hv, sv))


@pytest.mark.parametrize("shape", [(3, 5, 2000, 300), (2, 25, 64_000, 1000),
                                   (2, 1, 200_000, 10_000),
                                   (2, 8, 60_000, 100_000)])
def test_stacked_rows_equal_separate_launches(card, shape):
    """D stacked hash rows in one launch equal D one-row launches bitwise
    (each output is the same sum in the same order: the chunks of I
    depend on B, I and J only)."""
    D, B, I, J = shape
    x, h, s = _cs_inputs(D, B, I, J, card, seed=4)
    stacked = count_sketch_op(x, h, s, J)
    y = stacked.contiguous()
    looked = unsketch_op(y, h, s)
    for d in range(D):
        assert torch.equal(stacked[d], count_sketch_op(x, h[d], s[d], J))
        assert torch.equal(looked[d], unsketch_op(y[d], h[d], s[d]))
    assert plan(D, B, I, J, 4).chunks == plan(1, B, I, J, 4).chunks
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        count_sketch(x.double(), h, s, J)
    with pytest.raises(ValueError, match="int16 bucket links"):
        count_sketch(x, h, s, J, bucket_links(h, s, J).int())
    with pytest.raises(ValueError, match="int32"):
        unsketch(y, h.long(), s)


def test_sketched_rtpm_launches_both_kernels(card):
    """FCS RTPM on the card (I = 20, rank 2, D = 3) goes through
    count_sketch and unsketch and agrees with the same run on the CPU:
    lambdas within 1e-3 x max|lambda|."""
    gen = torch.Generator().manual_seed(5)
    Q = torch.linalg.qr(torch.randn((20, 20), generator=gen))[0][:, :2]
    T = torch.einsum("r,ar,br,cr->abc", torch.tensor([2.0, 1.0]), Q, Q, Q)
    hashes = make_tensor_hashes(T.shape, 500, 3, generator=gen,
                                device="cpu")
    inits = torch.randn((2, 6, 20), generator=gen)
    on_card = tuple(mode_hash_from_coeffs(mh.coeffs, mh.I, mh.J, card)
                    for mh in hashes)
    before = (count_sketch.launches, unsketch.launches)
    lk, _ = rtpm_decompose(T.to(card), 2, method="fcs", n_inits=6,
                           n_iters=10, hashes=on_card, inits=inits)
    assert count_sketch.launches > before[0]
    assert unsketch.launches > before[1]
    lc, _ = rtpm_decompose(T, 2, method="fcs", n_inits=6, n_iters=10,
                           hashes=hashes, inits=inits)
    torch.testing.assert_close(lk.cpu(), lc, rtol=0,
                               atol=1e-3 * lc.abs().max().item())
