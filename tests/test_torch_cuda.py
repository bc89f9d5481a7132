"""The port on the card: the sm_90a paged-attention, sketch_update,
tail_fold, tail_scores, count_sketch and unsketch kernels against their
plain versions, the model's kernel path against its plain path, the slot
engine launching the paged-attention kernel (and, sketched, the tail
kernels), verify rows bitwise decode rows, the speculative engine's
greedy tokens bitwise the plain engine's (its draft through count_sketch
and unsketch), the decode chunk replayed as CUDA graphs bitwise its eager
twin (plain, sketched and speculative engines), the sketched optimizer
launching sketch_update, sketched RTPM launching count_sketch and
unsketch, the reduced moe configs graphed bitwise their eager twins
with kernel-path logits within tolerance of the plain path, and the
reduced recurrent configs' engines (xlstm-1.3b, zamba2-2.7b) graphed
bitwise their eager twins, an admission in the overlap window landing
in place, an FCS-compressed gradient leaf on the card against its CPU
computation from the same hashes, and a reduced moe and xlstm train step
on the card against the CPU's.  Every test
carries the ``cuda`` marker and skips without a card; the file imports
nothing of JAX, so it runs on the card's machine:

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
from repro_torch.kernels.kv_sketch import (tail_fold, tail_products,
                                           tail_scores, tail_select)
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


@pytest.mark.parametrize("Sq", range(2, 10))
def test_kernel_verify_rows_are_decode_rows_bitwise(card, Sq):
    """A verify call (Sq = spec_k + 1 rows a slot) at gemma-2b's serve
    geometry: row i is bitwise the Sq = 1 call's at start + i, since the
    planner's KV splits ignore Sq."""
    args = _inputs(8, Sq, 1, 8, 256, 256, 16, 32, card, seed=Sq)
    q, kp, vp, tables, start, fb = args
    m, l, acc = paged_attention(*args)
    for i in range(Sq):
        mi, li, ai = paged_attention(q[:, i:i + 1].contiguous(), kp, vp,
                                     tables, start + i, fb)
        assert torch.equal(m[..., i], mi[..., 0])
        assert torch.equal(l[..., i], li[..., 0])
        assert torch.equal(acc[..., i, :], ai[..., 0, :])


@pytest.mark.parametrize("Sq", [2, 3, 5])
def test_tail_attend_verify_rows_are_decode_rows_bitwise(card, Sq):
    """The sketched tail span at gemma-2b's 8k shapes: each row of a
    verify call equals the Sq = 1 call at its position, bitwise (the
    tail_scores kernel, the one-chunk count sketch and the padded value
    contraction are all row-invariant and deterministic)."""
    from repro_torch.serve import kv_sketch as kvs
    B, K, R, hd, Z = 8, 1, 8, 256, 3
    C, T = kvs.tail_cols(8192, 8), kvs.pos_domain(8192, 16)
    coeffs = cached_coeffs(3, Z, device=card)
    ph = kvs.pos_buckets_signs(coeffs, T, C)
    g = torch.Generator(card).manual_seed(Sq)
    tk = torch.randn((B, Z, C, K, hd), generator=g, device=card)
    tv = torch.randn((B, Z, C, K, hd), generator=g, device=card)
    q = torch.randn((B, Sq, K, R, hd), generator=g, device=card).to(
        torch.bfloat16)
    fb = torch.tensor([0, 752, 608, 768, 704, 736, 176, 1024],
                      dtype=torch.int32, device=card)
    full = kvs.tail_attend(q, tk, tv, coeffs, ph, fb, 1 / 16)
    again = kvs.tail_attend(q, tk, tv, coeffs, ph, fb, 1 / 16)
    assert all(torch.equal(a, b) for a, b in zip(full, again))
    for i in range(Sq):
        one = kvs.tail_attend(q[:, i:i + 1].contiguous(), tk, tv, coeffs,
                              ph, fb, 1 / 16)
        for a, b in zip(full, one):
            assert torch.equal(a[:, :, :, i], b[:, :, :, 0]), i


def test_one_chunk_count_sketch_is_its_tiled_model(card):
    """``chunks=1`` on the card: bitwise the tiled model, and a row's
    sketch the same bits in calls of 64 and 192 rows."""
    from repro_torch.serve import kv_sketch as kvs
    T, C, Z = 8192, 1024, 3
    ph = kvs.pos_buckets_signs(cached_coeffs(5, Z, device=card), T, C)
    x = torch.rand((192, T), generator=torch.Generator(card).manual_seed(2),
                   device=card)
    got = count_sketch(x, ph.bk, ph.sg, C, ph.links, chunks=1)
    assert torch.equal(got, ref.count_sketch_tiled_ref(x, ph.bk, ph.sg, C,
                                                       chunks=1))
    assert torch.equal(got[:, :64],
                       count_sketch(x[:64], ph.bk, ph.sg, C, ph.links,
                                    chunks=1))


def test_sketched_head_count_sketch_matches_plain_version(card):
    """The FCS-sketched head's activation sketch on the card: rows of
    bf16 hidden states under the head's hash (gemma-2b's d_model, J at
    ratio 4), against the plain version within one bf16 rounding, and
    its gradient (the signed lookup) bitwise the plain one."""
    from repro_torch.models import layers as ly
    d, J = 2048, 512
    h, sg, links = ly.head_hash(1234, d, J, card)
    x = torch.randn((64, d), generator=torch.Generator(card).manual_seed(3),
                    device=card).to(torch.bfloat16)
    before = count_sketch.launches
    got = count_sketch_op(x, h, sg, J, index=links)
    assert count_sketch.launches == before + 1
    want = ref.count_sketch_ref(x, h, sg, J)
    tol = 2 ** -7 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    g = torch.randn((64, J), device=card)
    assert torch.equal(unsketch_op(g, h, sg), ref.unsketch_ref(g, h, sg))


@pytest.mark.parametrize("B,C", [(8, 5), (24, 5)])
def test_verify_logits_are_decode_logits_on_the_card(card, B, C):
    """Reduced gemma-2b on the card: verify logits at position index + i
    and the pool rows are bitwise C sequential decode steps' when both
    pad their rows to one count: 64 (the engine's at max_batch 8), and
    128, past one row tile (B 24: the verify step's 120 rows)."""
    from repro_torch.models import layers as ly
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, seed=6, device=card)
    bs, nbs = 8, 6
    NB = B * nbs
    g = torch.Generator(card).manual_seed(B)
    toks = torch.randint(0, cfg.vocab_size, (B, C), generator=g,
                         device=card)
    tables = torch.arange(NB, dtype=torch.int32, device=card).reshape(B, nbs)
    pos = torch.randint(0, nbs * bs - C, (B,), generator=g, device=card,
                        dtype=torch.int32)
    rows = ly.padded_rows(B * C)
    cache_v = tf.init_paged_cache(cfg, NB, bs, card)
    cache_d = tf.init_paged_cache(cfg, NB, bs, card)
    lg_v, _ = tf.verify_step(params, cache_v, toks, pos, cfg, tables,
                             rows=rows)
    for i in range(C):
        lg_d, _ = tf.decode_step(params, cache_d, toks[:, i:i + 1], pos + i,
                                 cfg, tables, rows=rows)
        assert torch.equal(lg_v[:, i], lg_d), f"offset {i}"
    for k in ("k", "v"):
        assert torch.equal(cache_v["kv"][k], cache_d["kv"][k])


@pytest.mark.parametrize("arch,B,C", [("gemma-2b", 24, 5),
                                      ("deepseek-moe-16b", 8, 9)])
def test_verify_past_the_step_rows_on_the_card(card, arch, B, C):
    """Reduced configs on the card: a verify step of B x C rows past the
    engine's 64 step rows runs every row op in slabs of 64 (120 and 72
    rows: two slabs), and its logits and pool rows are bitwise C decode
    steps' at the same step rows.  deepseek-moe's 72 verify rows route
    in three groups of 32 tokens, which may drop choices that its 8-row
    decode steps keep: its logits are held on the rows whose slot
    dropped nothing in either step up to them (router logits and shared
    experts run at the padded rows, each group's experts in a launch of
    its own)."""
    from repro_torch.models import layers as ly
    from repro_torch.models.routing import RoutingProbe
    cfg = reduced_config(arch)
    params = tf.init_params(cfg, seed=7, device=card)
    bs, nbs = 8, 6
    NB = B * nbs
    g = torch.Generator(card).manual_seed(B + C)
    toks = torch.randint(0, cfg.vocab_size, (B, C), generator=g,
                         device=card)
    tables = torch.arange(NB, dtype=torch.int32, device=card).reshape(B, nbs)
    pos = torch.randint(0, nbs * bs - C, (B,), generator=g, device=card,
                        dtype=torch.int32)
    rows = ly.padded_rows(B)
    assert B * C > rows
    cache_v = tf.init_paged_cache(cfg, NB, bs, card)
    cache_d = tf.init_paged_cache(cfg, NB, bs, card)
    with RoutingProbe() as rv:
        lg_v, _ = tf.verify_step(params, cache_v, toks, pos, cfg, tables,
                                 rows=rows)
    with RoutingProbe() as rd:
        steps = [tf.decode_step(params, cache_d, toks[:, i:i + 1], pos + i,
                                cfg, tables, rows=rows)[0]
                 for i in range(C)]
    clean = torch.ones((B, C), dtype=torch.bool, device=card)
    if cfg.family == "moe":
        L, K = cfg.num_layers, cfg.moe.top_k
        kept = lambda c, n: c.keep.reshape(-1, K)[:n].all(-1)
        for l in range(L):
            clean &= kept(rv.calls[l], B * C).view(B, C)
            for i in range(C):
                clean[:, i] &= kept(rd.calls[i * L + l], B)
        clean = torch.cumprod(clean.int(), dim=1).bool()
        assert clean.sum() >= B * C // 2
    for i in range(C):
        ok = clean[:, i]
        assert torch.equal(lg_v[ok, i], steps[i][ok]), f"offset {i}"
    if bool(clean.all()):
        for k in ("k", "v"):
            assert torch.equal(cache_v["kv"][k], cache_d["kv"][k])


@pytest.mark.parametrize("max_batch", [3, 16])
def test_spec_engine_greedy_equals_plain_on_the_card(card, max_batch):
    """Reduced gemma-2b: a spec engine (truncated draft, and a
    count-sketch-compressed one with the sketched head) gives the plain
    engine's greedy tokens bitwise, launching the paged-attention,
    count_sketch and unsketch kernels; no block leaks.  At max_batch 16
    the verify step's 64 rows fill the decode step's padded row count."""
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, seed=4, device=card)
    base = dataclasses.replace(cfg.serve, max_batch=max_batch, max_seq=96,
                               prefill_bucket=16, decode_chunk=4)
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, tokens=rng.randint(0, 512, n).astype(np.int32),
                    max_new=7) for i, n in enumerate((5, 16, 9, 23, 12))]
    ref_tok = {c.rid: c.tokens.tolist() for c in SlotScheduler(
        cfg, params, serve=base, device=card).run(list(reqs))}
    for ratio in (0, 2):
        launches = (paged_attention.launches, count_sketch.launches,
                    unsketch.launches)
        sched = SlotScheduler(cfg, params, serve=dataclasses.replace(
            base, spec_k=3, draft_depth=1, draft_sketch_ratio=ratio),
            device=card)
        got = {c.rid: c.tokens.tolist() for c in sched.run(list(reqs))}
        assert got == ref_tok
        assert sched.stats().spec_rounds > 0
        assert sched.alloc.reserved == sched.prefix_cache.held_blocks()
        assert paged_attention.launches > launches[0]
        if ratio:
            assert count_sketch.launches > launches[1]
            assert unsketch.launches > launches[2]


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


# (rows, cols, c0, width, base, dtype, work space): a rank's block of a
# (rows, cols) matrix split along its columns, as one strided piece: a
# yi-9b w_gate layer's block on 256 ranks at the leaf's last layer's
# offset (past 2^31), a ragged block, and one whose accumulate is cut
# into groups in the middle of a row
STRIDED_SHAPES = [
    (4096, 11008, 43 * 7, 43, 2_119_172_096, torch.bfloat16, None),
    (300, 1000, 500, 333, 12_345, torch.float32, None),
    (512, 4096, 1024, 1024, 0, torch.bfloat16, 100_000 * 6 * 4),
]


@pytest.mark.parametrize("shape", STRIDED_SHAPES)
def test_strided_piece_kernel_matches_per_row_pieces(card, shape,
                                                     monkeypatch):
    """The kernel's strided piece ``(g, offset, row, stride)`` in the
    count, scatter, slab-add, retrieve and apply passes: its tables within
    the tables' tolerance of the same block given as one contiguous piece
    a row and of the plain version (the slab adds vary in order); from
    equal tables, its estimates and its AdamW step bitwise the per-row
    pieces' and the plain path's."""
    from repro_torch.kernels import sketch_update as su
    rows, cols, c0, w, base, dtype, ws = shape
    if ws is not None:
        monkeypatch.setattr(su, "WORKSPACE_BYTES", ws)
    rng = np.random.RandomState(rows)
    g = torch.tensor(rng.randn(rows, w), dtype=dtype, device=card)
    p = torch.tensor(rng.randn(rows, w), dtype=torch.bfloat16, device=card)
    R, C = 3, 40_000
    mt = torch.tensor(rng.randn(R, C), dtype=torch.float32, device=card)
    vt = torch.tensor(np.abs(rng.randn(R, C)), dtype=torch.float32,
                      device=card)
    cm, cv = cached_coeffs(5, R, device=card), cached_coeffs(6, R,
                                                             device=card)
    strided = [(g, base + c0, w, cols)]
    per_row = [(g[r], base + r * cols + c0) for r in range(rows)]
    if ws is not None:
        assert len(plan_groups([rows * w], R, entry_bytes(dtype))) > 1
    sm, sv, rm, rv = mt.clone(), vt.clone(), mt.clone(), vt.clone()
    accumulate(strided, sm, sv, cm, cv, b1=0.9, b2=0.95)
    accumulate(per_row, rm, rv, cm, cv, b1=0.9, b2=0.95)
    new_m, new_v = ref.sketch_accumulate_ref(strided, mt, vt, cm, cv, 0.9,
                                             0.95)
    for got in ((sm, sv), (rm, rv)):
        for x, y in zip(got, (new_m, new_v)):
            torch.testing.assert_close(x, y, rtol=1e-5,
                                       atol=1e-5 * y.abs().max().item())
    est = list(sketch_update(strided, sm.clone(), sv.clone(), cm, cv, b1=1.0,
                             b2=1.0))[0]
    rows_est = list(sketch_update(per_row, sm.clone(), sv.clone(), cm, cv,
                                  b1=1.0, b2=1.0))
    plain = ref.sketch_retrieve_ref(rows * w, base + c0, sm, sv, cm, cv, w,
                                    cols)
    for i in range(2):
        want = torch.cat([e[i] for e in rows_est])
        assert torch.equal(est[i], want) and torch.equal(est[i], plain[i])
    hyper = dict(lr=1e-2, eps=1e-8, weight_decay=0.01, bc1=0.1, bc2=0.05)
    a, b, c = p.clone(), p.clone(), p.clone()
    su.step(strided, [a.reshape(-1)], sm, sv, cm, cv, **hyper)
    su.step(per_row, list(b), sm, sv, cm, cv, **hyper)
    ref.sketch_step_ref(strided, [c.reshape(-1)], sm, sv, cm, cv, **hyper)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_chunked_attention_matches_the_dense_form_at_4096(card):
    """Reduced yi-9b's attention block in bf16 at B 2, S 4096, kv_chunk
    1024 on the card: the output and the gradients of x and of every
    weight for a seeded cotangent, within 2% and 5% of max|dense| of one
    f32 softmax over the whole masked S x S scores from the same bf16
    projections (the chunked form rounds its scores, its probabilities
    and each product to bf16, as the reference does)."""
    from repro_torch.models import layers as ly
    cfg = reduced_config("yi-9b")
    params = tf.init_params(cfg, seed=9, device=card)
    p = params["blocks"][0]["attn"]
    S, hd = 4096, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    gen = torch.Generator(card).manual_seed(9)
    x = torch.randn(2, S, cfg.d_model, generator=gen, device=card).to(
        torch.bfloat16)
    w = torch.randn(2, S, cfg.d_model, generator=gen, device=card)

    def dense(pp, xx):
        q, k, v = ly._project_qkv_rope(pp, xx, cfg, torch.arange(
            S, device=card))
        k = k.repeat_interleave(H // K, dim=2).float()
        v = v.repeat_interleave(H // K, dim=2).float()
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / np.sqrt(hd)
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool,
                                      device=card).tril(), -1e30)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        return ly.linear(o.reshape(2, S, H * hd).to(xx.dtype), pp["wo"])

    outs = []
    for fn in (lambda pp, xx: ly.causal_attention(pp, xx, cfg, 1024), dense):
        leaves = {k: t.clone().requires_grad_(True) for k, t in p.items()}
        xx = x.clone().requires_grad_(True)
        o = fn(leaves, xx)
        (o.float() * w).sum().backward()
        outs.append([o.detach()] + [xx.grad] + [leaves[k].grad
                                                for k in sorted(leaves)])
    for i, (got, want) in enumerate(zip(*outs)):
        tol = 0.02 if i == 0 else 0.05
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), (i, err)


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


@pytest.mark.parametrize("shape", FOLD_SHAPES)
@pytest.mark.parametrize("n", [2, 4])
def test_tail_fold_column_range_is_bitwise_its_columns(card, shape, n):
    """A tail split by bucket columns: each shard's fold is bitwise the
    unsharded fold's columns, and within 1e-5 x max|table| of the plain
    range fold."""
    rows, pos, counts, tail, cf = _fold_inputs(*shape, card, seed=6)
    C = tail.shape[2]
    whole = tail.clone()
    tail_fold(rows, pos, counts, whole, cf)
    w = C // n
    for c0 in range(0, n * w, w):
        part = tail[:, :, c0:c0 + w].contiguous()
        want = ref.tail_fold_ref(rows, pos, counts, part.clone(), cf, c0, C)
        tail_fold(rows, pos, counts, part, cf, c0, C)
        torch.cuda.synchronize()
        assert torch.equal(part, whole[:, :, c0:c0 + w])
        torch.testing.assert_close(part, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("shape", SCORE_SHAPES)
def test_split_score_passes_are_bitwise_tail_scores(card, shape):
    """The products pass on column shards, gathered, then the select pass:
    bitwise the fused ``tail_scores``; the products within 1e-4 x max of
    the plain products."""
    B, K, N, hd, Z, C, T = shape
    rng = np.random.RandomState(2)
    q = torch.tensor(rng.randn(B, K, N, hd), dtype=torch.float32,
                     device=card)
    tk = torch.tensor(rng.randn(B, Z, C, K, hd), dtype=torch.float32,
                      device=card)
    cf = cached_coeffs(11, Z, device=card)
    cuts = [0, C // 3, C // 2, C]
    p0, s0 = tail_products.launches, tail_select.launches
    prod = torch.cat([tail_products(q, tk[:, :, a:b].contiguous())
                      for a, b in zip(cuts, cuts[1:])], dim=-1)
    got = tail_select(prod, cf, T)
    torch.cuda.synchronize()
    assert (tail_products.launches, tail_select.launches) == (p0 + 3, s0 + 1)
    assert torch.equal(got, tail_scores(q, tk, cf, T))
    want = ref.tail_products_ref(q, tk)
    torch.testing.assert_close(prod, want, rtol=0,
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


# ---------------------------------------------------------------------------
# The decode and prefill chunks as CUDA graphs (serve/graphs.py): graphed vs
# eager twin
# ---------------------------------------------------------------------------


def _chunk_log(sched):
    """Record each collected chunk's (tokens, emit flags) on the host."""
    log = []
    collect = sched.collect

    def spy():
        log.append(sched._inflight[0].cpu().numpy())
        return collect()

    sched.collect = spy
    return log


def _pools_equal(a, b):
    """Pool rows [:, :NB] of both pools of a spec engine, and the tails."""
    for ca, cb in zip(a._pools(), b._pools()):
        for k in ("k", "v"):
            assert torch.equal(ca["kv"][k][:, :a.num_blocks],
                               cb["kv"][k][:, :b.num_blocks]), k
        if a.sketch_on:
            assert torch.equal(ca["tail"], cb["tail"])


def _graphed_and_eager(cfg, params, serve, make_reqs, card, passes=2):
    """The same stream through a graphed engine and its eager twin, in
    ``passes`` passes each: tokens, emit flags (and the tokens they
    flag), completion order, allocator books, pool rows and tail tables
    (after the first pass's prefill and decode, and at the end), kernel
    launch counts and the callers' generator states bitwise equal; the
    decode and prefill captures each equal the variants used and do not
    grow after the first pass; no leaked blocks.  Returns the graphed
    scheduler."""
    from repro_torch.serve.graphs import launch_counters
    out = {}
    for graphs in (True, False):
        sched = SlotScheduler(cfg, params, serve=serve, device=card,
                              graphs=graphs)
        log = _chunk_log(sched)
        gens, done, caps, pcaps, pools = [], [], [], [], []
        before = [w.launches for w in launch_counters()]
        for p in range(passes):
            reqs = make_reqs(100 * p)
            gens += [r.generator for r in reqs if r.generator is not None]
            done += sched.run(reqs)
            caps.append(sched.decode_compilations)
            pcaps.append(sched.prefill_compilations)
            if p == 0:              # the sink block (index NB) left out
                pools.append([{k: t[:, :sched.num_blocks].clone()
                               for k, t in c["kv"].items()}
                              for c in sched._pools()])
        torch.cuda.synchronize()
        launches = [w.launches - b for w, b in zip(launch_counters(), before)]
        out[graphs] = dict(sched=sched, log=log, done=done, caps=caps,
                           pcaps=pcaps, pools=pools, launches=launches,
                           gens=[g.get_state() for g in gens])
    g, e = out[True], out[False]
    assert [c.rid for c in g["done"]] == [c.rid for c in e["done"]]
    for a, b in zip(g["done"], e["done"]):
        assert np.array_equal(a.tokens, b.tokens), a.rid
    assert len(g["log"]) == len(e["log"])
    for a, b in zip(g["log"], e["log"]):
        fa, fb = a[1].astype(bool), b[1].astype(bool)
        assert np.array_equal(fa, fb)
        assert np.array_equal(a[0][fa], b[0][fb])
    gs, es = g["sched"], e["sched"]
    assert (gs.alloc.peak_reserved, gs.alloc.rc.tolist(),
            sorted(gs.alloc._free)) == (es.alloc.peak_reserved,
                                        es.alloc.rc.tolist(),
                                        sorted(es.alloc._free))
    assert gs.alloc.reserved == gs.prefix_cache.held_blocks()
    _pools_equal(gs, es)
    for a, b in zip(g["pools"][0], e["pools"][0]):
        assert all(torch.equal(a[k], b[k]) for k in ("k", "v"))
    assert g["launches"] == e["launches"] and g["launches"][0] > 0
    assert all(torch.equal(a, b) for a, b in zip(g["gens"], e["gens"]))
    used = len(gs._graphs.replays)
    assert g["caps"] == [used] * passes and used >= 1
    assert e["caps"] == [0] * passes
    pused = len(gs._prefill_graphs.replays)
    assert g["pcaps"] == [pused] * passes
    assert pused == 1 or (gs.sketch_on and pused == 2)
    assert e["pcaps"] == [0] * passes
    assert gs._prefill_graphs.pool_bytes() > 0
    assert gs._prefill_graphs._pool != gs._graphs._pool
    return gs


def _stream(cfg, lens, sampled, rid0, card, max_new=7):
    rng = np.random.RandomState(rid0 + 1)
    reqs = []
    for i, n in enumerate(lens):
        gen = None
        if i in sampled:
            gen = torch.Generator(card).manual_seed(rid0 + 50 + i)
        reqs.append(Request(
            rid=rid0 + i, tokens=rng.randint(0, cfg.vocab_size, n).astype(
                np.int32), max_new=max_new,
            temperature=0.8 if i in sampled else 0.0, top_k=8 * (i % 2),
            generator=gen, seed=None if gen is not None else rid0 + i))
    return reqs


def test_graphed_plain_engine_is_its_eager_twin(card):
    """Reduced gemma-2b, greedy and sampled requests (sampled ones from
    callers' generators) through the graphed plain engine and its eager
    twin: both variants used, everything bitwise."""
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, seed=7, device=card)
    serve = dataclasses.replace(cfg.serve, max_batch=3, max_seq=96,
                                prefill_bucket=16, decode_chunk=4)
    gs = _graphed_and_eager(
        cfg, params, serve,
        lambda r0: (_stream(cfg, (5, 16, 9), (), r0, card)
                    + _stream(cfg, (23, 12, 30), (1, 2), r0 + 10, card)),
        card)
    assert {v.sampled for v in gs._graphs.replays} == {False, True}


MOE_ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_graphed_moe_engine_is_its_eager_twin(card, arch):
    """Reduced moe configs (deepseek's with a shared expert): the routed
    decode and prefill chunks, captured, replay bitwise as their eager
    twins — routing, the integer slot table, the gathers and the f32
    combine are fixed-shape and atomic-free."""
    cfg = reduced_config(arch)
    params = tf.init_params(cfg, seed=7, device=card)
    serve = dataclasses.replace(cfg.serve, max_batch=3, max_seq=96,
                                prefill_bucket=16, decode_chunk=4)
    gs = _graphed_and_eager(
        cfg, params, serve,
        lambda r0: (_stream(cfg, (5, 16, 9), (), r0, card)
                    + _stream(cfg, (23, 12, 30), (1, 2), r0 + 10, card)),
        card)
    assert {v.sampled for v in gs._graphs.replays} == {False, True}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_logits_kernel_vs_plain(card, arch):
    """Reduced moe decode (rows padded as an engine's) and chunk logits on
    the card, the kernel path against the plain path on identical caches,
    the plain path forced onto the kernel path's experts
    (models/routing.py): 3% of max|logit|, as the CPU model parity tests,
    and every routing decision the plain path would have made otherwise
    within 0.1 router logits of a tie."""
    from repro_torch.models import layers as ly
    from repro_torch.models.routing import RoutingProbe
    cfg = reduced_config(arch)
    params = tf.init_params(cfg, seed=1, device=card)
    NB, bs, nbs = 16, 8, 6
    cache = tf.init_paged_cache(cfg, NB, bs, card)
    tables = torch.full((3, nbs), NB, dtype=torch.int32, device=card)
    tables[0, :4] = torch.tensor([3, 7, 1, 9], dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (1, 32), device=card,
                           generator=torch.Generator(card).manual_seed(0))
    for off in (0, 8, 16):
        tf.prefill_chunk(params, cache, prompt[:, off:off + 8], tables[0],
                         off, cfg)
    pos = torch.tensor([24, 0, 0], dtype=torch.int32, device=card)
    cur = torch.tensor([[5], [6], [7]], device=card)
    start = torch.tensor([24], dtype=torch.int32, device=card)
    clone = lambda c: {"kv": {k: v.clone() for k, v in c["kv"].items()}}
    out = []
    routing = None
    for kernels in (None, False):
        with RoutingProbe(None if routing is None
                          else routing.forcing()) as routing:
            ld, _ = tf.decode_step(params, clone(cache), cur, pos, cfg,
                                   tables, kernels=kernels, rows=64)
            y, _ = tf.forward(params, tf.embed_inputs(params, prompt[:, 24:]),
                              cfg, mode="chunk", cache=clone(cache),
                              index=start, tables=tables[:1],
                              kernels=kernels)
        out.append((ld[:2], ly.logits_fn(params, y, cfg)))
    assert routing.worst <= 0.1, routing.worst
    for lk, lp in zip(*out):
        torch.testing.assert_close(lk, lp, rtol=0,
                                   atol=0.03 * lp.abs().max().item())


def test_graphed_sketched_engine_is_its_eager_twin(card):
    """A sketched engine (window 32) whose long prompts fold, mixed with
    short and sampled ones: tail tables, tokens and books bitwise the
    eager twin's in every variant the stream picks."""
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, seed=8, device=card)
    serve = dataclasses.replace(
        cfg.serve, max_batch=3, max_seq=256, prefill_bucket=16,
        decode_chunk=4, kv_block_size=16, prefix_block=16,
        kv_sketch_window=32, admit_threshold=1 << 30)

    def make(r0):
        return (_stream(cfg, (12, 20), (), r0, card)
                + _stream(cfg, (14,), (0,), r0 + 10, card)
                + _stream(cfg, (70, 90), (), r0 + 20, card)
                + _stream(cfg, (55, 12), (0,), r0 + 30, card))

    gs = _graphed_and_eager(cfg, params, serve, make, card)
    assert gs.fold_rows_total > 0
    assert any(v.sketched for v in gs._graphs.replays)


@pytest.mark.parametrize("ratio", [0, 2])
def test_graphed_spec_engine_is_its_eager_twin(card, ratio):
    """A truncated spec engine (ratio 0) and a count-sketch-compressed one
    with the sketched head (ratio 2), spec_k 3: the graphed spec chunk is
    its eager twin bitwise, and its greedy tokens are the plain engine's."""
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, seed=9, device=card)
    base = dataclasses.replace(cfg.serve, max_batch=3, max_seq=96,
                               prefill_bucket=16, decode_chunk=4)
    serve = dataclasses.replace(base, spec_k=3, draft_depth=1,
                                draft_sketch_ratio=ratio)
    make = lambda r0: _stream(cfg, (5, 16, 9, 23, 12), (3,), r0, card)
    gs = _graphed_and_eager(cfg, params, serve, make, card)
    assert gs.stats().spec_rounds > 0
    plain = SlotScheduler(cfg, params, serve=base, device=card)
    want = {c.rid: c.tokens for c in plain.run(make(0))}
    got = {c.rid: c.tokens for c in SlotScheduler(
        cfg, params, serve=serve, device=card).run(make(0))}
    for rid in (0, 1, 2, 4):
        assert np.array_equal(got[rid], want[rid]), rid


def test_graphed_prefill_resumes_prefix_hits_as_its_eager_twin(card):
    """Prompts sharing one base (admission threshold 1, prefix blocks of
    16, buckets of 32): the prefix hits resume at a bucket boundary, inside
    a bucket (the overlap rows recompute) and past the whole prompt, and
    the one captured prefill chunk replays each bitwise as the eager
    twin runs it."""
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, seed=10, device=card)
    serve = dataclasses.replace(cfg.serve, max_batch=3, max_seq=128,
                                prefill_bucket=32, decode_chunk=4,
                                prefix_block=16, admit_threshold=1)

    def make(r0):
        rng = np.random.RandomState(r0 + 3)
        base = rng.randint(0, cfg.vocab_size, 80).astype(np.int32)
        return [Request(rid=r0 + i, tokens=np.concatenate(
            [base[:n], rng.randint(0, cfg.vocab_size, t).astype(np.int32)]),
            max_new=5) for i, (n, t) in enumerate(
                ((40, 5), (56, 3), (70, 2), (80, 4), (64, 0)))]

    gs = _graphed_and_eager(cfg, params, serve, make, card)
    assert gs.prefill_compilations == 1
    assert gs.stats().prefix_hits == 8


def test_graphed_sketched_spec_prefill_is_its_eager_twin(card):
    """A sketched spec engine (window 32, spec_k 2, depth-1 draft) whose
    prompts fold through prefill: both prefill variants captured once, the
    draft's pool and tails written in the target's replay, bitwise the
    eager twin's."""
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, seed=11, device=card)
    serve = dataclasses.replace(
        cfg.serve, max_batch=3, max_seq=256, prefill_bucket=16,
        decode_chunk=4, kv_block_size=16, prefix_block=16,
        kv_sketch_window=32, admit_threshold=1 << 30, spec_k=2,
        draft_depth=1)
    make = lambda r0: _stream(cfg, (12, 70, 90, 55), (3,), r0, card)
    gs = _graphed_and_eager(cfg, params, serve, make, card)
    assert gs.prefill_compilations == 2 and gs.fold_rows_total > 0
    assert float(gs._state.cache["draft"]["tail"].abs().sum()) > 0


def test_prefill_replayed_in_the_overlap_window(card):
    """The front end prefills while a decode chunk is in flight: after
    ``dispatch`` and before ``collect`` a new admission replays the
    captured prefill (its own memory pool) several chunks long, and the
    in-flight chunk's tokens, every later chunk and the pools stay the
    eager twin's bitwise."""
    cfg = reduced_config("gemma-2b")
    params = tf.init_params(cfg, seed=12, device=card)
    serve = dataclasses.replace(cfg.serve, max_batch=4, max_seq=256,
                                prefill_bucket=16, decode_chunk=8)
    out = {}
    for graphs in (True, False):
        sched = SlotScheduler(cfg, params, serve=serve, device=card,
                              graphs=graphs)
        reqs = _stream(cfg, (20, 33, 150, 120), (1,), 0, card, max_new=24)
        for r in reqs[:2]:
            sched.submit(r)
        sched.admit_pending()
        assert sched.dispatch()
        sched.collect()
        assert sched.dispatch()             # a chunk in flight
        before = (None if sched._prefill_graphs is None
                  else dict(sched._prefill_graphs.replays))
        for r in reqs[2:]:
            sched.submit(r)
        assert sched.admit_pending() == 2   # 18 prefill chunks meanwhile
        window = sched._inflight[0].cpu().numpy()
        assert window[1][:, 2:].sum() == 0  # the new slots emit nothing
        if graphs:
            assert sum(sched._prefill_graphs.replays.values()) - sum(
                before.values()) == 18
        sched.collect()
        sched.drain()
        torch.cuda.synchronize()
        out[graphs] = (window, sched, [(c.rid, c.tokens) for c in
                                       sched.completed])
    (wg, gs, dg), (we, es, de) = out[True], out[False]
    # the emit flags and the tokens they flag (an idle slot's unflagged
    # token depends on the warm-up, which only the graphed engine runs)
    assert np.array_equal(wg[1], we[1]) and wg[1].any()
    assert np.array_equal(wg[0][wg[1] > 0], we[0][we[1] > 0])
    assert len(dg) == len(de) == 4
    for (ra, ta), (rb, tb) in zip(dg, de):
        assert ra == rb and np.array_equal(ta, tb)
    _pools_equal(gs, es)
    assert gs.prefill_compilations == 1


# ---------------------------------------------------------------------------
# The recurrent families' slot engine (no kernel of their own: the decode
# chunk captured and replayed over in-place state updates)
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ["xlstm-1.3b", "zamba2-2.7b"]


def _state_bits(cache):
    """Every leaf of a recurrent slot state, as integers (NaN-safe)."""
    out = []
    tf.tree_map(lambda t: out.append(t.view(
        {4: torch.int32, 2: torch.int16}[t.element_size()]).clone()), cache)
    return out


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_graphed_recurrent_engine_is_its_eager_twin(card, arch):
    """Reduced xlstm-1.3b / zamba2-2.7b: prompts of 1-4 tokens (the conv
    stash's edges, a 1-token prompt zeroing its slot) and longer ones,
    greedy and sampled, two passes through a graphed engine and its eager
    twin: tokens, emit flags, completion order, every slot state leaf at
    the end and the callers' generator states bitwise; one decode capture
    per variant used, none more on the second pass, no prefill capture;
    no state leaf padded past max_batch rows."""
    cfg = reduced_config(arch)
    params = tf.init_params(cfg, seed=9, device=card)
    serve = dataclasses.replace(cfg.serve, max_batch=3, max_seq=96,
                                decode_chunk=4)
    out = {}
    for graphs in (True, False):
        sched = SlotScheduler(cfg, params, serve=serve, device=card,
                              graphs=graphs)
        log = _chunk_log(sched)
        done, caps, pcaps, gens = [], [], [], []
        for p in range(2):
            reqs = (_stream(cfg, (1, 2, 3, 4), (1,), 100 * p, card)
                    + _stream(cfg, (40, 17, 60), (0,), 100 * p + 10, card))
            gens += [r.generator for r in reqs if r.generator is not None]
            done += sched.run(reqs)
            caps.append(sched.decode_compilations)
            pcaps.append(sched.prefill_compilations)
        torch.cuda.synchronize()
        out[graphs] = dict(sched=sched, log=log, done=done, caps=caps,
                           pcaps=pcaps, state=_state_bits(sched._state.cache),
                           gens=[g.get_state() for g in gens])
    g, e = out[True], out[False]
    assert [c.rid for c in g["done"]] == [c.rid for c in e["done"]]
    for a, b in zip(g["done"], e["done"]):
        assert np.array_equal(a.tokens, b.tokens), a.rid
        assert a.status == "ok" and len(a.tokens) == 7
    assert len(g["log"]) == len(e["log"])
    for a, b in zip(g["log"], e["log"]):
        fa, fb = a[1].astype(bool), b[1].astype(bool)
        assert np.array_equal(fa, fb)
        assert np.array_equal(a[0][fa], b[0][fb])
    assert all(torch.equal(a, b) for a, b in zip(g["state"], e["state"]))
    assert all(torch.equal(a, b) for a, b in zip(g["gens"], e["gens"]))
    gs = g["sched"]
    used = len(gs._graphs.replays)
    assert g["caps"] == [used] * 2 and used >= 1
    assert e["caps"] == [0, 0] and g["pcaps"] == e["pcaps"] == [0, 0]
    assert gs._prefill_graphs is None
    leaves = []
    tf.tree_map(leaves.append, gs._state.cache)
    assert all(t.shape[1] == serve.max_batch for t in leaves)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_admission_between_dispatches_lands_in_place(card, arch):
    """An admission while a decode chunk is in flight (the front end's
    overlap): the new slots' prefilled state is copied into the slot
    state in place (every leaf keeps its address, which the captured
    chunk reads), the in-flight chunk emits nothing for them, and the
    in-flight chunk's tokens, every later chunk and the final state are
    the eager twin's bitwise."""
    cfg = reduced_config(arch)
    params = tf.init_params(cfg, seed=13, device=card)
    serve = dataclasses.replace(cfg.serve, max_batch=4, max_seq=128,
                                decode_chunk=8)
    out = {}
    for graphs in (True, False):
        sched = SlotScheduler(cfg, params, serve=serve, device=card,
                              graphs=graphs)
        reqs = _stream(cfg, (20, 33, 1, 70), (1,), 0, card, max_new=24)
        addrs = []
        tf.tree_map(lambda t: addrs.append(t.data_ptr()), sched._state.cache)
        for r in reqs[:2]:
            sched.submit(r)
        sched.admit_pending()
        assert sched.dispatch()
        sched.collect()
        assert sched.dispatch()             # a chunk in flight
        for r in reqs[2:]:
            sched.submit(r)
        assert sched.admit_pending() == 2
        window = sched._inflight[0].cpu().numpy()
        assert window[1][:, 2:].sum() == 0  # the new slots emit nothing
        sched.collect()
        sched.drain()
        torch.cuda.synchronize()
        after = []
        tf.tree_map(lambda t: after.append(t.data_ptr()), sched._state.cache)
        assert after == addrs
        out[graphs] = (window, [(c.rid, c.tokens) for c in sched.completed],
                       _state_bits(sched._state.cache))
    (wg, dg, sg), (we, de, se) = out[True], out[False]
    assert np.array_equal(wg[1], we[1]) and wg[1].any()
    assert np.array_equal(wg[0][wg[1] > 0], we[0][we[1] > 0])
    assert len(dg) == len(de) == 4
    for (ra, ta), (rb, tb) in zip(dg, de):
        assert ra == rb and np.array_equal(ta, tb)
    assert all(torch.equal(a, b) for a, b in zip(sg, se))


# ---------------------------------------------------------------------------
# Training every family; FCS gradient compression
# ---------------------------------------------------------------------------


def test_compressed_leaf_on_the_card_equals_its_cpu_computation(card):
    """A stacked leaf of three pieces whose rows straddle them, a padded
    tail and chunks cut small: from the same hashes, the card's sketch
    within f32 rounding of the CPU's (``index_add_`` adds with atomics in
    a varying order), its estimate given the CPU's sketch bitwise the
    CPU's, and the round trip in place in bf16 bitwise the estimate of
    its own sketch."""
    from repro_torch.train import grad_compress as gcm
    g = torch.as_tensor(np.random.RandomState(3).randn(3, 700, 33)
                        .astype(np.float32))
    n = g.numel()
    c = gcm.LeafCodec(5, -(-n // 16), 16, -(-n // 16) + 15,
                      -(-n // 16) * 16 - n)
    assert c.pad > 0
    tables = gcm.codec_hashes(c, 1234, 7, torch.device("cpu"))
    ctables = tuple(t.to(card) for t in tables)
    pieces = list(g)
    sk = gcm.sketch_leaf(pieces, c, tables)
    csk = gcm.sketch_leaf([p.to(card) for p in pieces], c, ctables)
    torch.testing.assert_close(csk.cpu(), sk, rtol=1e-5,
                               atol=1e-6 * sk.abs().max().item())
    est = gcm.unsketch_leaf(sk, c, tables, pieces)
    cest = gcm.unsketch_leaf(sk.to(card), c, ctables,
                             [p.to(card) for p in pieces])
    for a, b in zip(cest, est):
        assert torch.equal(a.cpu(), b)
    gb = [p.to(card, torch.bfloat16) for p in pieces]
    own = gcm.compress_roundtrip(gb, c, ctables)
    want = gcm.unsketch_leaf(own, c, ctables, gb, dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(gb, want))
    # the card draws its own hashes, reproducibly from (seed, step, leaf)
    a = gcm.codec_hashes(c, 1234, 7, card)
    b = gcm.codec_hashes(c, 1234, 7, card)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "xlstm-1.3b"])
def test_train_step_on_the_card_matches_the_cpu(card, arch):
    """One reduced train step, the same params and batch on the card and
    the CPU: granite in bf16 on the CPU's routing (recorded there, forced
    on the card in the forward and each block's recompute; the forcing
    changes only near-ties of the card's own routing), loss rtol 1e-3 and
    each gradient leaf within 6% of max |CPU| with cosine >= 0.999, as
    the CPU tests hold the port to the reference; xlstm in f32 (its
    random reduced bf16 forward sits 15-49% from f32), each leaf within
    1e-3 of max |CPU|."""
    from repro_torch.models import layers as ly
    from repro_torch.models import model as M
    from repro_torch.models.routing import RoutingProbe
    from repro_torch.train import data as data_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(arch)
    params = tf.init_params(cfg, seed=2, device="cpu")
    f32 = cfg.family == "ssm"
    prev = ly.PDTYPE
    if f32:
        params = tf.tree_map(lambda t: t.float(), params)
        ly.PDTYPE = torch.float32
    try:
        batch = data_lib.make_batch(cfg, 0, 2, 24, device="cpu")
        step = M.make_train_step(cfg)
        if cfg.family == "moe":
            with RoutingProbe() as rec:
                loss, grads = step(params, batch)
            forcing = {k: v[:1] for k, v in rec.forcing().items()}
            forced = RoutingProbe({k: v * 2 for k, v in forcing.items()})
        else:
            loss, grads = step(params, batch)
            forced = None
        cparams = tf.tree_map(lambda t: t.to(card), params)
        cbatch = {k: v.to(card) for k, v in batch.items()}
        if forced is not None:
            with forced:
                closs, cgrads = step(cparams, cbatch)
            assert forced.worst < 0.02
        else:
            closs, cgrads = step(cparams, cbatch)
    finally:
        ly.PDTYPE = prev
    torch.testing.assert_close(closs.cpu(), loss, rtol=1e-3, atol=0)
    for (name, a), (_, b) in zip(tf.param_leaves(cgrads),
                                 tf.param_leaves(grads)):
        got = torch.stack([t.float().cpu() for t in a])
        want = torch.stack([t.float() for t in b])
        tol = (1e-3 if f32 else 0.06) * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol, name
        if not f32 and want.abs().max() > 0:
            cos = (got * want).sum() / (got.norm() * want.norm())
            assert cos >= 0.999, (name, float(cos))


# ---------------------------------------------------------------------------
# The launch tooling at a mesh of one (a world-1 NCCL group)
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_one(card, tmp_path):
    import torch.distributed as dist
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, device_id=card)
    try:
        yield card
    finally:
        dist.destroy_process_group()


def _local(tree):
    return tf.tree_map(lambda t: t.to_local() if hasattr(t, "to_local")
                       else t, tree)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_sharded_train_step_on_a_mesh_of_one(nccl_one, monkeypatch):
    """FSDP placements on a (1, 1) mesh (the byte threshold at 0, so the
    reduced leaves shard): loss and gradients bitwise the unsharded
    step's, and sketched AdamW on the DTensor params after it launches
    sketch_update and moves every sketched leaf."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.sharding import logical_rules
    from repro_torch.train import data as data_lib
    card = nccl_one
    monkeypatch.setattr(SH, "_FSDP_MIN_BYTES", 0)
    cfg = reduced_config("yi-9b")
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    rules, strategy = SH.make_rules(cfg, "train", False, False, 2)
    params = tf.init_params(cfg, seed=2, device=card)
    batch = data_lib.make_batch(cfg, 0, 2, 32, device=card)
    pd = SH.distribute(params, SH.build_param_pspecs(cfg, params, rules,
                                                     strategy), mesh)
    bd = SH.distribute(batch, {k: (rules["batch"], None) for k in batch},
                       mesh)
    step = M.make_train_step(cfg)
    with logical_rules(rules), implicit_replication():
        loss1, grads1 = step(pd, bd)
    loss0, grads0 = step(_local(pd), batch)
    assert torch.equal(loss1.to_local(), loss0)
    for (_, a), (_, b) in zip(tf.param_leaves(_local(grads1)),
                              tf.param_leaves(grads0)):
        for x, y in zip(a, b):
            assert torch.equal(_bits(x), _bits(y))
    sketch_update.launches = 0
    before = tf.tree_map(torch.clone, _local(pd))
    st = sketched_adamw_init(pd, 4, 3, 1024)
    sketched_adamw_update(grads1, st, pd)
    torch.cuda.synchronize()
    assert sketch_update.launches > 0
    for (_, a), (_, b), mo in zip(tf.param_leaves(_local(pd)),
                                  tf.param_leaves(before), st.moments):
        if hasattr(mo.m, "table"):
            assert torch.isfinite(mo.m.table).all()
            assert any(not torch.equal(_bits(x), _bits(y))
                       for x, y in zip(a, b))


def test_sharded_serve_step_on_a_mesh_of_one(nccl_one):
    """make_serve_step at the decode TP placements on a (1, 1) mesh:
    logits and pool rows bitwise the unsharded serve step's, through the
    paged-attention kernel."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.sharding import logical_rules
    card = nccl_one
    cfg = reduced_config("gemma-2b")
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    rules, _ = SH.make_rules(cfg, "decode", False, False)
    params = tf.init_params(cfg, seed=2, device=card)
    pd = SH.distribute(params, SH.build_param_pspecs(cfg, params, rules,
                                                     "tp"), mesh)
    cache = M.init_slot_cache(cfg, 4, 64, card)
    ref_cache = tf.tree_map(lambda t: t.clone(), cache)
    cd = SH.distribute(cache, SH.cache_pspecs(cfg, cache, rules), mesh)
    gen = torch.Generator(card).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (5, 4, 1), generator=gen,
                         device=card)
    step = M.make_serve_step(cfg)
    paged_attention.launches = 0
    with logical_rules(rules), implicit_replication():
        got = [step(pd, cd, toks[i], torch.full((4,), 3 + i, device=card,
                                                 dtype=torch.int32)
                    )[0].full_tensor() for i in range(5)]
    torch.cuda.synchronize()
    assert paged_attention.launches > 0
    want = [step(_local(pd), ref_cache, toks[i],
                 torch.full((4,), 3 + i, device=card, dtype=torch.int32))[0]
            for i in range(5)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pool = _local(cd)["kv"]
    for k in ("k", "v"):
        assert torch.equal(_bits(pool[k]), _bits(ref_cache["kv"][k]))


def test_podwise_step_on_a_pod_of_one(nccl_one):
    """The pod-wise compressed step over a pod group of one: every
    estimate bitwise unsketch_leaf of the pod-mean sketch, and the
    sketch bytes all-reduced the sum of J~ x 4."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import data as data_lib
    from repro_torch.train import grad_compress as gcm
    card = nccl_one
    cfg = dataclasses.replace(reduced_config("yi-9b"), d_model=128,
                              d_ff=256)
    params = tf.init_params(cfg, seed=2, device=card)
    batch = data_lib.make_batch(cfg, 0, 2, 16, device=card)
    seen = {}
    gcm.probe = lambda c, pieces, tables, sk: seen.__setitem__(
        c.leaf_id, sk.clone())
    try:
        step = gcm.make_podwise_compressed_step(
            cfg, make_mesh((1,), ("pod",), "cuda"))
        _, grads, _ = step(params, gcm.init_error_feedback(params), batch, 3)
    finally:
        gcm.probe = None
    codecs = gcm._leaf_codecs(params, cfg.sketch.grad_hash_ratio)
    assert seen and step.allreduced["sketch"] == sum(
        4 * c.Jt for c in codecs if c is not None)
    for (_, pieces), c in zip(tf.param_leaves(grads), codecs):
        if c is None:
            continue
        tables = gcm.codec_hashes(c, cfg.sketch.seed, 3, card)
        est = gcm.unsketch_leaf(seen[c.leaf_id], c, tables, pieces,
                                pieces[0].dtype)
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(est, pieces))
