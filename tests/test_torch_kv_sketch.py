"""Port parity: the sketched long-context KV math of ``repro_torch``
(serve/kv_sketch.py and the plain versions of its kernels in
kernels/ref.py) against the JAX package, on inputs made by numpy from a
seed and handed to both.

Tolerances.  Hashes, buckets, signs, columns and position domains are
integers and must be equal.  The fold sums the same f32 terms in another
order (JAX contracts a signed one-hot, the port index-adds): tables within
1e-6 x max|table|.  Score estimates are one hd-term f32 dot product per
bucket in another order, then an exact gather and median: within
1e-5 x max|estimate|.  Attention statistics (m, l, acc) go through exp
and a softmax-weighted sum of a few hundred terms: within 1e-5 relative
(of max |value|).  An empty tail (fold_base == 0) gives exactly
(-1e30, 0, 0).  The model-level check carries the reference's weights,
pool and tail tables across and holds logits to the model tolerance of
tests/test_torch_model.py (3% of max |logit|); slots that folded nothing
must equal the port's sketch-free step bitwise.  The CUDA fold's tiled
model (``tail_fold_tiled_ref``, defined here) equals the row-by-row fold
bitwise: each table element receives the same f32 additions in the same
order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.kernels import kv_sketch as rkk
from repro.kernels import ref as rref
from repro.models import transformer as rtf
from repro.serve import kv_sketch as rkvs
from repro.sketch.hashing import cached_coeffs as ref_coeffs
from repro_torch.configs.registry import reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.models import bridge
from repro_torch.models import transformer as tf
from repro_torch.serve import kv_sketch as kvs
from repro_torch.sketch.hashing import cached_coeffs, row_buckets_signs

torch.set_num_threads(1)

ROWS = [2, 3, 4]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# Integers: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,rows", [(0, 3), (7, 2), (12345, 4)])
def test_integer_helpers_bitwise(seed, rows):
    sv = dataclasses.replace(ref_reduced("gemma-2b").serve, seed=seed,
                             kv_sketch_rows=rows)
    tsv = dataclasses.replace(reduced_config("gemma-2b").serve, seed=seed,
                              kv_sketch_rows=rows)
    assert kvs.tail_seed(tsv) == rkvs.tail_seed(sv)
    np.testing.assert_array_equal(kvs.tail_coeffs(tsv).numpy(),
                                  np.asarray(rkvs.tail_coeffs(sv)))
    for max_seq, ratio, bs in ((8192, 8, 16), (128, 8, 16), (1000, 3, 12),
                               (96, 1, 8), (7, 4, 16)):
        assert kvs.tail_cols(max_seq, ratio) == rkvs.tail_cols(max_seq,
                                                               ratio)
        assert kvs.pos_domain(max_seq, bs) == rkvs.pos_domain(max_seq, bs)
    T, C = 200, 48
    np.testing.assert_array_equal(
        kvs.pos_onehot(kvs.tail_coeffs(tsv), T, C).numpy(),
        np.asarray(rkvs.pos_onehot(rkvs.tail_coeffs(sv), T, C)))


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Z", ROWS)
def test_tail_fold_ref_matches_reference(Z):
    """Against the TPU kernel in interpret mode (as tests/test_kernels.py
    runs it) and its oracle, rows masked past their count."""
    rng = np.random.RandomState(Z)
    C, D, N, T = 48, 64, 150, 200
    rows = rng.randn(N, D).astype(np.float32)
    pos = rng.randint(0, T, (N,)).astype(np.int32)
    tail = rng.randn(Z, C, D).astype(np.float32)
    jc = ref_coeffs(7, Z)
    want = np.asarray(rref.kv_tail_fold_ref(jnp.asarray(rows),
                                            jnp.asarray(pos),
                                            jnp.asarray(tail), jc))
    kern = np.asarray(rkk.tail_fold(jnp.asarray(rows), jnp.asarray(pos),
                                    jnp.asarray(tail), jc, bN=64, bC=32))
    # two batch elements: the rows above, and the same rows with a count
    # that drops the last 50 (their table must equal folding 100 rows)
    got = _t(np.stack([tail, tail])).clone()
    extra = rng.randn(N, D).astype(np.float32)
    ref.tail_fold_ref(_t(np.stack([rows, np.where(
        np.arange(N)[:, None] < 100, rows, extra)])),
        _t(np.stack([pos, pos])), torch.tensor([N, 100], dtype=torch.int32),
        got, cached_coeffs(7, Z))
    _close(got[0], want, 1e-6)
    _close(got[0], kern, 1e-6)
    want100 = np.asarray(rref.kv_tail_fold_ref(
        jnp.asarray(rows[:100]), jnp.asarray(pos[:100]), jnp.asarray(tail),
        jc))
    _close(got[1], want100, 1e-6)


def tail_fold_tiled_ref(rows: torch.Tensor, positions: torch.Tensor,
                        counts: torch.Tensor, tail: torch.Tensor,
                        coeffs: torch.Tensor, tile: int = 32
                        ) -> torch.Tensor:
    """The CUDA kernel's tiling of the fold: per (g, z) table, rows in
    tiles of ``tile``; in a tile each bucket's first row gathers the
    table row, adds the tile's rows of that bucket in increasing n and
    writes it back once.  In place; returns ``tail``."""
    G, N, D = rows.shape
    _, Z, C, _ = tail.shape
    bk, sg = row_buckets_signs(coeffs, positions.reshape(-1), C,
                               signed=True)
    bk, sg = bk.reshape(Z, G, N).tolist(), sg.reshape(Z, G, N)
    for g in range(G):
        n_valid = min(int(counts[g]), N)
        x = rows[g].float()
        for z in range(Z):
            for n0 in range(0, n_valid, tile):
                chain = {}                   # bucket -> rows, in order
                for n in range(n0, min(n0 + tile, n_valid)):
                    chain.setdefault(bk[z][g][n], []).append(n)
                for b, ns in chain.items():
                    v = tail[g, z, b].clone()
                    for n in ns:
                        v = v + (-x[n] if sg[z, g, n] < 0 else x[n])
                    tail[g, z, b] = v
    return tail


def _fold_inputs(G, N, Z, C, D, span, seed):
    """Positions drawn from ``span`` values, so rows repeat positions and
    every hash row collides inside a tile."""
    rng = np.random.RandomState(seed)
    rows = torch.tensor(rng.randn(G, N, D), dtype=torch.bfloat16)
    pos = torch.tensor(rng.randint(0, span, (G, N)), dtype=torch.int32)
    counts = torch.tensor(rng.randint(0, N + 1, G), dtype=torch.int32)
    counts[0] = N
    tail = torch.tensor(rng.randn(G, Z, C, D), dtype=torch.float32)
    return rows, pos, counts, tail


@pytest.mark.parametrize("Z,N,span", [(2, 70, 40), (3, 100, 500),
                                      (4, 33, 10)])
def test_tiled_fold_equals_rowwise_fold_bitwise(Z, N, span):
    G, C, D = 4, 64, 24
    rows, pos, counts, tail = _fold_inputs(G, N, Z, C, D, span, seed=Z)
    cf = cached_coeffs(Z + 5, Z)
    bk, _ = row_buckets_signs(cf, pos[0, :32].reshape(-1), C, signed=True)
    assert all(len(set(r)) < 32 for r in bk.tolist())   # collisions
    got = tail_fold_tiled_ref(rows, pos, counts, tail.clone(), cf)
    want = ref.tail_fold_rowwise_ref(rows, pos, counts, tail.clone(), cf)
    assert torch.equal(got, want)
    np.testing.assert_allclose(
        got.numpy(), ref.tail_fold_ref(rows, pos, counts, tail.clone(),
                                       cf).numpy(),
        rtol=0, atol=1e-6 * float(got.abs().max()))


@pytest.mark.parametrize("Z", [2, 3])
def test_tiled_fold_matches_reference_kernel(Z):
    """Against the TPU kernel in interpret mode, one table at a time."""
    G, N, C, D = 2, 70, 64, 32
    rows, pos, counts, tail = _fold_inputs(G, N, Z, C, D, 90, seed=10 + Z)
    rows, counts[1] = rows.float(), 45
    jc = ref_coeffs(7, Z)
    got = tail_fold_tiled_ref(rows, pos, counts, tail.clone(),
                                  cached_coeffs(7, Z))
    for g in range(G):
        n = int(counts[g])
        want = np.asarray(rkk.tail_fold(
            jnp.asarray(rows[g, :n].numpy()), jnp.asarray(pos[g, :n].numpy()),
            jnp.asarray(tail[g].numpy()), jc, bN=32, bC=32))
        np.testing.assert_allclose(got[g].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("Z", ROWS)
def test_tail_scores_ref_matches_reference(Z):
    rng = np.random.RandomState(10 + Z)
    C, D, N, T = 32, 48, 20, 130
    q = rng.randn(N, D).astype(np.float32)
    tk = rng.randn(Z, C, D).astype(np.float32)
    jc = ref_coeffs(11, Z)
    want = np.asarray(rref.kv_tail_scores_ref(jnp.asarray(q),
                                              jnp.asarray(tk), jc, T))
    kern = np.asarray(rkk.tail_scores(jnp.asarray(q), jnp.asarray(tk), jc,
                                      T=T, bN=16, bT=64))
    got = ref.tail_scores_ref(_t(q)[None, None], _t(tk)[None, :, :, None],
                              cached_coeffs(11, Z), T)[0, 0].numpy()
    _close(got, want, 1e-5)
    _close(got, kern, 1e-5)


def test_tail_scores_ref_batches_heads():
    """(B, K) batching: each kv head's rows read that head's tables."""
    rng = np.random.RandomState(3)
    B, K, N, hd, Z, C, T = 2, 3, 5, 16, 3, 32, 96
    q = rng.randn(B, K, N, hd).astype(np.float32)
    tk = rng.randn(B, Z, C, K, hd).astype(np.float32)
    cf = cached_coeffs(2, Z)
    got = ref.tail_scores_ref(_t(q), _t(tk), cf, T).numpy()
    for b in range(B):
        for k in range(K):
            want = np.asarray(rref.kv_tail_scores_ref(
                jnp.asarray(q[b, k]), jnp.asarray(tk[b, :, :, k]),
                ref_coeffs(2, Z), T))
            _close(got[b, k], want, 1e-5)


def test_ops_refuse_the_kernel_on_cpu_tensors():
    cf = cached_coeffs(1, 3)
    rows = torch.zeros((1, 4, 8))
    pos = torch.zeros((1, 4), dtype=torch.int32)
    cnt = torch.ones((1,), dtype=torch.int32)
    tail = torch.zeros((1, 3, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.tail_fold_op(rows, pos, cnt, tail, cf, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.tail_scores_op(torch.zeros((1, 1, 2, 8)),
                           torch.zeros((1, 3, 16, 1, 8)), cf, 32,
                           use_kernel=True)
    # None picks the plain version for CPU tensors
    ops.tail_fold_op(rows, pos, cnt, tail, cf)
    assert ops.tail_scores_op(torch.zeros((1, 1, 2, 8)),
                              torch.zeros((1, 3, 16, 1, 8)), cf,
                              32).shape == (1, 1, 2, 32)


# ---------------------------------------------------------------------------
# serve/kv_sketch.py
# ---------------------------------------------------------------------------


def _pool_case(seed=1):
    rng = np.random.RandomState(seed)
    L, NB, bs, K, hd, B, nb = 2, 12, 8, 2, 16, 3, 5
    Z, C = 3, 32
    pool = {n: rng.randn(L, NB, bs, K, hd).astype(np.float32)
            for n in ("k", "v")}
    tables = np.full((B, nb), NB, np.int32)
    perm = rng.permutation(NB)
    tables[0, :4] = perm[:4]
    tables[1, :3] = perm[4:7]
    tables[2, 1:5] = perm[7:11]          # slot 2 already folded block 0
    fold_from = np.array([0, 8, 8], np.int32)
    fold_len = np.array([16, 0, 24], np.int32)
    tail = {n: rng.randn(L, B, Z, C, K, hd).astype(np.float32)
            for n in ("k", "v")}
    return pool, tables, fold_from, fold_len, tail, (L, NB, bs, K, hd, Z, C)


def test_fold_pool_matches_reference():
    pool, tables, ff, fl, tail, (L, NB, bs, K, hd, Z, C) = _pool_case()
    sv = dataclasses.replace(ref_reduced("gemma-2b").serve, kv_sketch_rows=Z)
    tsv = dataclasses.replace(reduced_config("gemma-2b").serve,
                              kv_sketch_rows=Z)
    want = rkvs.fold_pool({n: jnp.asarray(a) for n, a in pool.items()},
                          {n: jnp.asarray(a) for n, a in tail.items()},
                          jnp.asarray(tables), jnp.asarray(ff),
                          jnp.asarray(fl), rkvs.tail_coeffs(sv), fold_cap=32)
    # the port's pool carries a write-sink block per layer
    tpool = {n: torch.cat([_t(a), torch.zeros((L, 1, bs, K, hd))], dim=1)
             for n, a in pool.items()}
    got = bridge.tail_from_reference(tail, device="cpu")
    kvs.fold_pool(tpool, got, _t(tables), _t(ff), _t(fl),
                  kvs.tail_coeffs(tsv), fold_cap=32)
    for i, n in enumerate(("k", "v")):
        _close(got[i], want[n], 1e-6)
    # one slot's view of the stacked tables, as the prefill fold-through
    # passes it: only that slot changes
    one = bridge.tail_from_reference(tail, device="cpu")
    kvs.fold_pool(tpool, one[:, :, 2:3], _t(tables[2:3]), _t(ff[2:3]),
                  _t(fl[2:3]), kvs.tail_coeffs(tsv), fold_cap=32)
    for i, n in enumerate(("k", "v")):
        _close(one[i, :, 2], want[n][:, 2], 1e-6)
        np.testing.assert_array_equal(one[i, :, :2].numpy(), tail[n][:, :2])


def test_fold_rows_matches_reference():
    rng = np.random.RandomState(4)
    B, n, K, hd, Z, C = 2, 40, 2, 8, 3, 48
    k = rng.randn(B, n, K, hd).astype(np.float32)
    v = rng.randn(B, n, K, hd).astype(np.float32)
    pos = rng.randint(0, 500, (n,)).astype(np.int32)
    want = rkvs.fold_rows(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                          ref_coeffs(9, Z), C)
    got = kvs.fold_rows(_t(k), _t(v), _t(pos), cached_coeffs(9, Z), C)
    _close(got[0], want["k"], 1e-6)
    _close(got[1], want["v"], 1e-6)


def _attend_case(seed=0):
    rng = np.random.RandomState(seed)
    B, Sq, K, R, hd, T, Z, C = 3, 2, 2, 2, 16, 96, 3, 32
    kr = rng.randn(B, T, K, hd).astype(np.float32)
    vr = rng.randn(B, T, K, hd).astype(np.float32)
    q = rng.randn(B, Sq, K, R, hd).astype(np.float32)
    fb = np.array([0, 40, T], np.int32)
    return q, kr, vr, fb, (B, Sq, K, R, hd, T, Z, C)


def test_tail_attend_matches_reference():
    q, kr, vr, fb, (B, Sq, K, R, hd, T, Z, C) = _attend_case()
    scale = 1.0 / np.sqrt(hd)
    jc, tc = ref_coeffs(5, Z), cached_coeffs(5, Z)
    rtail = rkvs.fold_rows(jnp.asarray(kr), jnp.asarray(vr),
                           jnp.arange(T, dtype=jnp.int32), jc, C)
    want = rkvs.tail_attend(jnp.asarray(q), rtail["k"], rtail["v"],
                            rkvs.pos_onehot(jc, T, C), jnp.asarray(fb),
                            scale)
    ttail = kvs.fold_rows(_t(kr), _t(vr), torch.arange(T), tc, C)
    got = kvs.tail_attend(_t(q), ttail[0], ttail[1], tc,
                          kvs.pos_buckets_signs(tc, T, C), _t(fb), scale)
    for g, w in zip(got, want):
        _close(g[1:], np.asarray(w)[1:], 1e-5)
    m, l, acc = got
    # the empty tail contributes exactly nothing
    assert bool((m[0] == -1e30).all()) and bool((l[0] == 0).all())
    assert bool((acc[0] == 0).all())


def test_merge_and_exact_span_stats_match_reference():
    q, kr, vr, fb, (B, Sq, K, R, hd, T, Z, C) = _attend_case(2)
    scale = 1.0 / np.sqrt(hd)
    want_t = rkvs.dense_tail_stats(jnp.asarray(q), jnp.asarray(kr),
                                   jnp.asarray(vr), jnp.asarray(fb), scale)
    got_t = kvs.dense_tail_stats(_t(q), _t(kr), _t(vr), _t(fb), scale)
    for g, w in zip(got_t, want_t):
        _close(g, w, 1e-5)
    # an exact span over the last rows, merged with the dense tail
    live = np.arange(T)[None, :] >= fb[:, None]
    s = np.einsum("bqkrh,bskh->bkrqs", q, kr) * scale
    s = np.where(live[:, None, None, None, :], s, -1e30).astype(np.float32)
    lv = live[:, None, None, None, :]
    want_e = rkvs.exact_span_stats(jnp.asarray(s), jnp.asarray(vr),
                                   jnp.asarray(lv))
    got_e = kvs.exact_span_stats(_t(s), _t(vr), _t(lv))
    for g, w in zip(got_e, want_e):
        _close(g[:2], np.asarray(w)[:2], 1e-5)
    want = rkvs.merge_spans(*want_e, *want_t)
    got = kvs.merge_spans(*got_e, *got_t)
    _close(got[:2], np.asarray(want)[:2], 1e-5)


def test_tail_row_spread_matches_reference():
    rng = np.random.RandomState(6)
    tail = {n: rng.randn(2, 3, 3, 16, 1, 8).astype(np.float32)
            for n in ("k", "v")}
    tail["k"][:, 1] = 0.0
    tail["v"][:, 1] = 0.0                       # slot 1 empty
    want = rkvs.tail_row_spread({n: jnp.asarray(a) for n, a in tail.items()})
    got = kvs.tail_row_spread(bridge.tail_from_reference(tail, "cpu"))
    _close(got, want, 1e-5)
    assert float(got[1]) == 0.0


# ---------------------------------------------------------------------------
# The model: two-span decode with the reference's weights, pool and tails
# ---------------------------------------------------------------------------


def test_two_span_decode_matches_reference():
    cfg, tcfg = ref_reduced("gemma-2b"), reduced_config("gemma-2b")
    params = rtf.init_params(jax.random.PRNGKey(0), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    rng = np.random.RandomState(0)
    B, NB, bs, nbs, T, Z, C = 4, 24, 8, 6, 48, 3, 16
    sv = dataclasses.replace(cfg.serve, kv_sketch_rows=Z)
    tsv = dataclasses.replace(tcfg.serve, kv_sketch_rows=Z)
    cache = rtf.init_paged_cache(cfg, NB, bs)
    tables = np.full((B, nbs), NB, np.int32)
    lens = [40, 30, 20, 36]
    nxt = 0
    for b, n in enumerate(lens):
        k = -(-(n + 1) // bs)
        tables[b, :k] = np.arange(nxt, nxt + k)
        nxt += k
        prompt = rng.randint(0, cfg.vocab_size, (1, n)).astype(np.int32)
        for off in range(0, n, 8):
            tok = np.zeros((1, 8), np.int32)
            tok[0, :len(prompt[0, off:off + 8])] = prompt[0, off:off + 8]
            cache = rtf.prefill_chunk(params, cache, jnp.asarray(tok),
                                      jnp.asarray(tables[b]), off, cfg)
    # fold the first 16 rows of slots 0 and 3 (of 2 layers) through the
    # reference's fold_pool; slots 1 and 2 fold nothing
    fb = np.array([16, 0, 0, 8], np.int32)
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    tail0 = {n: jnp.zeros((L, B, Z, C, K, hd), jnp.float32)
             for n in ("k", "v")}
    jc = rkvs.tail_coeffs(sv)
    tail = rkvs.fold_pool(cache["kv"], tail0, jnp.asarray(tables),
                          jnp.zeros((B,), jnp.int32), jnp.asarray(fb), jc,
                          fold_cap=16)
    cur = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.asarray(lens, np.int32)
    want, _ = rtf.decode_step(params, {**cache, "tail": tail},
                              jnp.asarray(cur), jnp.asarray(pos), cfg,
                              tables=jnp.asarray(tables),
                              sketch={"fold_base": jnp.asarray(fb),
                                      "onehot": rkvs.pos_onehot(jc, T, C)})
    want = np.asarray(want)[:, :cfg.vocab_size]

    def tcache():
        kv = {n: torch.cat([bridge.to_torch(np.asarray(cache["kv"][n]),
                                            "cpu"),
                            torch.zeros((L, 1, bs, K, hd),
                                        dtype=torch.bfloat16)], dim=1)
              for n in ("k", "v")}
        return {"kv": kv, "tail": bridge.tail_from_reference(
            jax.tree.map(np.asarray, tail), "cpu")}

    c = tcache()
    sk = {"fold_base": _t(fb), "tail": c["tail"],
          "coeffs": kvs.tail_coeffs(tsv),
          "pos_hash": kvs.pos_buckets_signs(kvs.tail_coeffs(tsv), T, C)}
    got, _ = tf.decode_step(tparams, c, _t(cur).long(), _t(pos), tcfg,
                            _t(tables), sketch=sk)
    plain, _ = tf.decode_step(tparams, tcache(), _t(cur).long(), _t(pos),
                              tcfg, _t(tables))
    got = got[:, :tcfg.vocab_size].numpy()
    tol = 0.03 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    srt = np.sort(want, axis=-1)
    sure = srt[:, -1] - srt[:, -2] > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])
    # the anchor: slots that folded nothing are the sketch-free step's
    plain = plain[:, :tcfg.vocab_size].numpy()
    np.testing.assert_array_equal(got[1:3], plain[1:3])
    assert not np.array_equal(got[0], plain[0])


@pytest.mark.parametrize("Sq", [2, 3, 5])
def test_tail_attend_rows_ignore_sq(Sq):
    """A query row's tail statistics are the same bits at any Sq: a
    verify step's rows (Sq = spec_k + 1) equal its decode steps' (Sq 1),
    the property greedy speculation over sketched KV rests on."""
    B, K, R, hd, Z, C, T = 3, 2, 2, 16, 3, 64, 256
    g = torch.Generator().manual_seed(Sq)
    tk = torch.randn((B, Z, C, K, hd), generator=g)
    tv = torch.randn((B, Z, C, K, hd), generator=g)
    q = torch.randn((B, Sq, K, R, hd), generator=g).to(torch.bfloat16)
    coeffs = cached_coeffs(11, Z)
    ph = kvs.pos_buckets_signs(coeffs, T, C)
    fb = torch.tensor([0, 48, 128], dtype=torch.int32)
    full = kvs.tail_attend(q, tk, tv, coeffs, ph, fb, 0.25)
    for i in range(Sq):
        one = kvs.tail_attend(q[:, i:i + 1].contiguous(), tk, tv, coeffs, ph,
                              fb, 0.25)
        for a, b in zip(full, one):
            assert torch.equal(a[:, :, :, i], b[:, :, :, 0]), i


@pytest.mark.parametrize("R,Sq", [(8, 9), (4, 17)])
def test_tail_attend_slabs_past_the_decode_rows(R, Sq):
    """Past the decode step's rows: a verify step of R * Sq > 64 tail-span
    rows (gemma-2b's 8 query heads a kv head at spec_k 8; reduced gemma's
    4 at spec_k 16) runs its value contraction in slabs of the decode
    step's ``padded_rows(R)`` rows, and each row's statistics are still
    the Sq = 1 call's bits."""
    from repro_torch.models.layers import padded_rows
    B, K, hd, Z, C, T = 2, 1, 16, 3, 64, 256
    slab = padded_rows(R)
    assert R * Sq > slab
    g = torch.Generator().manual_seed(R)
    tk = torch.randn((B, Z, C, K, hd), generator=g)
    tv = torch.randn((B, Z, C, K, hd), generator=g)
    q = torch.randn((B, Sq, K, R, hd), generator=g).to(torch.bfloat16)
    coeffs = cached_coeffs(11, Z)
    ph = kvs.pos_buckets_signs(coeffs, T, C)
    fb = torch.tensor([48, 128], dtype=torch.int32)
    full = kvs.tail_attend(q, tk, tv, coeffs, ph, fb, 0.25, slab=slab)
    for i in range(Sq):
        one = kvs.tail_attend(q[:, i:i + 1].contiguous(), tk, tv, coeffs, ph,
                              fb, 0.25, slab=slab)
        for a, b in zip(full, one):
            assert torch.equal(a[:, :, :, i], b[:, :, :, 0]), i
    # the same function as the one-call contraction
    for a, b in zip(full, kvs.tail_attend(q, tk, tv, coeffs, ph, fb, 0.25)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_one_chunk_count_sketch_rows_ignore_b():
    """``chunks=1`` fixes the kernel's order of additions by the hash and
    (I, J) alone: in its tiled model a row's sketch is the same bits in a
    call of 3 rows and of 200."""
    T, C, Z = 8192, 1024, 3
    ph = kvs.pos_buckets_signs(cached_coeffs(5, Z), T, C)
    x = torch.randn((200, T), generator=torch.Generator().manual_seed(1))
    big = ref.count_sketch_tiled_ref(x, ph.bk, ph.sg, C, chunks=1)
    small = ref.count_sketch_tiled_ref(x[:3], ph.bk, ph.sg, C, chunks=1)
    assert torch.equal(big[:, :3], small)
    np.testing.assert_allclose(big.numpy(),
                               ref.count_sketch_ref(x, ph.bk, ph.sg,
                                                    C).numpy(),
                               rtol=1e-5, atol=1e-5)
