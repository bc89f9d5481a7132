"""The port's two sharded paths in one process: two-span (sketched)
attention and its fold on a pool split by blocks and a tail split by
bucket columns, and expert-parallel MoE.

* The plain column-range fold (``ref.tail_fold_ref`` with ``col0`` /
  ``cols``) is bitwise its columns of the unsharded plain fold, and the
  split score passes (``tail_products_ref`` on column shards, gathered,
  then ``tail_select_ref``) bitwise ``tail_scores_ref``; the unsharded
  fold and tail statistics equal the reference's ``fold_rows`` /
  ``tail_attend`` at the tolerances of tests/test_torch_kv_sketch.py.
* The rank bodies (models/ranks.py) run on emulated ranks in lockstep
  (``run_ranks``), as chip_smoke.py runs them on one card: the sharded
  fold is bitwise the unsharded one's columns; the sharded tail
  statistics and one layer's decode and verify attention lie within f32
  rounding of the unsharded ones; expert-parallel MoE is bitwise the
  gathered form forward and in its expert gradients.
* The dry run's walk of deepseek-moe ``train_4k`` on the 2x16x16 mesh
  (cut to one layer) keeps its per-device argument bytes exact and
  gathers no expert leaf over ``model``; the gathered form does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import kv_sketch as rkvs
from repro.sketch.hashing import cached_coeffs as ref_coeffs
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as ly
from repro_torch.models import moe
from repro_torch.models import model as M
from repro_torch.models import ranks
from repro_torch.models import transformer as tf
from repro_torch.serve import kv_sketch as kvs
from repro_torch.sketch.hashing import cached_coeffs

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _fake_group_torn_down():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _cols(C, n):
    w = C // n
    return [(r * w, w) for r in range(n)]


# ---------------------------------------------------------------------------
# The plain versions of the new kernel forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Z,n", [(2, 2), (3, 4), (4, 2)])
def test_column_range_fold_is_bitwise_its_columns(Z, n):
    """Rows colliding inside a shard, ragged counts: each column shard's
    fold is bitwise the unsharded fold's columns; the unsharded fold
    equals the reference's ``fold_rows`` within 1e-6 x max|table|."""
    rng = np.random.RandomState(Z * 10 + n)
    B, N, K, hd, C = 3, 70, 2, 8, 48
    k = rng.randn(B, N, K, hd).astype(np.float32)
    v = rng.randn(B, N, K, hd).astype(np.float32)
    pos = rng.randint(0, 300, (N,)).astype(np.int32)
    want = rkvs.fold_rows(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                          ref_coeffs(9, Z), C)
    cf = cached_coeffs(9, Z)
    full = kvs.fold_rows(torch.as_tensor(k), torch.as_tensor(v),
                         torch.as_tensor(pos), cf, C)
    _close(full[0], want["k"], 1e-6)
    _close(full[1], want["v"], 1e-6)
    rows = torch.stack([torch.as_tensor(k), torch.as_tensor(v)]).reshape(
        2 * B, N, K * hd)
    p = torch.as_tensor(pos).expand(2 * B, N).contiguous()
    counts = torch.tensor([N, 50, 0, 13, N, 1], dtype=torch.int32)
    base = torch.as_tensor(rng.randn(2 * B, Z, C, K * hd).astype(np.float32))
    whole = ops.tail_fold_op(rows, p, counts, base.clone(), cf)
    for c0, w in _cols(C, n):
        part = ops.tail_fold_op(rows, p, counts,
                                base[:, :, c0:c0 + w].clone(), cf,
                                col0=c0, cols=C)
        assert torch.equal(part, whole[:, :, c0:c0 + w])


@pytest.mark.parametrize("Z,n,N", [(2, 2, 6), (3, 4, 5), (4, 2, 17)])
def test_split_score_passes_are_bitwise_tail_scores(Z, n, N):
    B, K, hd, C, T = 3, 2, 16, 64, 300
    g = torch.Generator().manual_seed(Z + n)
    q = torch.randn((B, K, N, hd), generator=g)
    tk = torch.randn((B, Z, C, K, hd), generator=g)
    cf = cached_coeffs(11, Z)
    prod = torch.cat([ops.tail_products_op(q, tk[:, :, c0:c0 + w]
                                           .contiguous())
                      for c0, w in _cols(C, n)], dim=-1)
    assert tuple(prod.shape) == (B, K, Z, N, C)
    assert torch.equal(prod, ref.tail_products_ref(q, tk))
    assert torch.equal(ops.tail_select_op(prod, cf, T),
                       ops.tail_scores_op(q, tk, cf, T))


def test_new_ops_refuse_the_kernel_on_cpu_tensors():
    q, tk = torch.zeros((1, 1, 2, 16)), torch.zeros((1, 2, 16, 1, 16))
    cf = cached_coeffs(1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.tail_products_op(q, tk, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.tail_select_op(torch.zeros((1, 1, 2, 2, 16)), cf, 32,
                           use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.tail_fold_op(torch.zeros((1, 4, 16)),
                         torch.zeros((1, 4), dtype=torch.int32),
                         torch.ones((1,), dtype=torch.int32),
                         torch.zeros((1, 2, 8, 16)), cf, use_kernel=True,
                         col0=8, cols=16)


# ---------------------------------------------------------------------------
# The rank runners
# ---------------------------------------------------------------------------


def _body(x, op, dim=0):
    y = yield ranks.Collective(op, x, dim)
    return y * 2


@pytest.mark.parametrize("op", ["gather", "sum", "max", "fan_out"])
def test_run_ranks_carries_out_each_collective_in_rank_order(op):
    xs = [torch.tensor([float(r), -float(r)]) for r in range(3)]
    got = ranks.run_ranks([_body(x, op) for x in xs])
    want = {"gather": [torch.cat(xs) * 2] * 3,
            "sum": [(xs[0] + xs[1] + xs[2]) * 2] * 3,
            "max": [torch.maximum(torch.maximum(xs[0], xs[1]), xs[2]) * 2] * 3,
            "fan_out": [x * 2 for x in xs]}[op]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(ranks.solo(_body(xs[1], op)), xs[1] * 2)


def test_run_ranks_refuses_mismatched_requests():
    bodies = [_body(torch.zeros(2), "sum"), _body(torch.zeros(2), "max")]
    with pytest.raises(RuntimeError, match="different collectives"):
        ranks.run_ranks(bodies)


# ---------------------------------------------------------------------------
# Emulated ranks: the sketched tail and its fold
# ---------------------------------------------------------------------------


def test_tail_attend_rank_matches_unsharded_and_reference():
    """Tail statistics on 4 column shards: the gathered products select
    estimates bitwise the unsharded kernel's plain version; (m, l, acc)
    within 1e-5 of the unsharded ones and of the reference's."""
    rng = np.random.RandomState(3)
    B, Sq, K, R, hd, T, Z, C = 3, 2, 2, 2, 16, 96, 3, 32
    kr = rng.randn(B, T, K, hd).astype(np.float32)
    vr = rng.randn(B, T, K, hd).astype(np.float32)
    q = rng.randn(B, Sq, K, R, hd).astype(np.float32)
    fb = np.array([0, 40, T], np.int32)
    jc, tc = ref_coeffs(5, Z), cached_coeffs(5, Z)
    rtail = rkvs.fold_rows(jnp.asarray(kr), jnp.asarray(vr),
                           jnp.arange(T, dtype=jnp.int32), jc, C)
    want = rkvs.tail_attend(jnp.asarray(q), rtail["k"], rtail["v"],
                            rkvs.pos_onehot(jc, T, C), jnp.asarray(fb),
                            0.25)
    tail = kvs.fold_rows(torch.as_tensor(kr), torch.as_tensor(vr),
                         torch.arange(T), tc, C)
    ph = kvs.pos_buckets_signs(tc, T, C)
    qt, fbt = torch.as_tensor(q), torch.as_tensor(fb)
    full = kvs.tail_attend(qt, tail[0], tail[1], tc, ph, fbt, 0.25)
    seen = []
    orig = ops.tail_select_op

    def spy(prod, *a, **k):
        out = orig(prod, *a, **k)
        seen.append(out)
        return out

    ops.tail_select_op = spy
    try:
        got = ranks.run_ranks([kvs.tail_attend_rank(
            qt, tail[0][:, :, c0:c0 + w].contiguous(),
            tail[1][:, :, c0:c0 + w].contiguous(), tc, ph, fbt, 0.25, c0)
            for c0, w in _cols(C, 4)])
    finally:
        ops.tail_select_op = orig
    est = ref.tail_scores_ref(kvs._query_rows(qt), tail[0], tc, T)
    assert len(seen) == 4 and all(torch.equal(e, est) for e in seen)
    for rank_out in got:
        for g, f, w in zip(rank_out, full, want):
            _close(g, f, 1e-5)
            _close(g[1:], np.asarray(w)[1:], 1e-5)


def _split_cache(cfg, n, seed):
    """A reduced gemma-2b one-layer pool of 4 slots laid out for n kv
    shards, filled with f32 rows, and its tail tables of 3 x 32."""
    cache = M.init_slot_cache(cfg, 4, 128, "cpu", (1, n), tail=(3, 32))
    g = torch.Generator().manual_seed(seed)
    pk = torch.randn(cache["kv"]["k"][0].shape, generator=g)
    pv = torch.randn(cache["kv"]["v"][0].shape, generator=g)
    tail = torch.randn(cache["tail"][:, :1].shape, generator=g)
    return pk, pv, cache["tables"], tail


@pytest.mark.parametrize("n", [2, 4])
def test_fold_pool_rank_is_bitwise_the_unsharded_fold(n):
    cfg = reduced_config("gemma-2b")
    pk, pv, tables, tail = _split_cache(cfg, n, n)
    coeffs = cached_coeffs(7, 3)
    ff = torch.tensor([0, 16, 32, 48], dtype=torch.int32)
    fl = torch.tensor([32, 16, 0, 32], dtype=torch.int32)
    want = kvs.fold_pool({"k": pk[None], "v": pv[None]}, tail.clone(),
                         tables, ff, fl, coeffs, 32)
    NB = pk.shape[0] - 1
    per = pk.shape[0] // n
    cols = _cols(tail.shape[4], n)
    got = ranks.run_ranks([kvs.fold_pool_rank(
        pk[None, r * per:(r + 1) * per], pv[None, r * per:(r + 1) * per],
        r * per, NB, tail[:, :, :, :, c0:c0 + w].clone(), c0,
        tail.shape[4], tables, ff, fl, coeffs, 32)
        for r, (c0, w) in enumerate(cols)])
    assert not torch.equal(want, tail)
    for (c0, w), t in zip(cols, got):
        assert torch.equal(t, want[:, :, :, :, c0:c0 + w])


@pytest.mark.parametrize("n,S", [(2, 1), (4, 1), (4, 3)])
def test_paged_attention_rank_matches_the_unsharded_layer(n, S):
    """One layer's two-span attention, decode (S 1) and verify (S 3), on
    n emulated ranks (pool blocks and tail columns split n ways): the
    output within 1e-5 x max of the unsharded layer's, the new rows
    written bitwise."""
    cfg = reduced_config("gemma-2b")
    p = tf.tree_map(lambda t: t.float(),
                    tf.init_params(cfg, seed=2, device="cpu"))["blocks"][0]
    pk, pv, tables, tail = _split_cache(cfg, n, 10 + n)
    B, d = 4, cfg.d_model
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    coeffs = cached_coeffs(7, 3)
    sketch = {"coeffs": coeffs, "pos_hash": kvs.pos_buckets_signs(
        coeffs, 128, tail.shape[4])}
    pos = torch.tensor([40, 70, 100, 20])[:, None] + torch.arange(S)
    fb = torch.tensor([16, 48, 0, 16], dtype=torch.int32)
    x = torch.randn((B, S, d), generator=torch.Generator().manual_seed(n))
    wk, wv = pk.clone(), pv.clone()
    want = ly.paged_self_attention(p["attn"], x, cfg, wk, wv, pos, tables,
                                   fb, None, (tail[0, 0], tail[1, 0]),
                                   sketch)
    q, kn, vn = ly._project_qkv_rope(p["attn"], x, cfg, pos)
    NB, per = pk.shape[0] - 1, pk.shape[0] // n
    shards = [(pk[r * per:(r + 1) * per].clone(),
               pv[r * per:(r + 1) * per].clone()) for r in range(n)]
    outs = ranks.run_ranks([ly.paged_attention_rank(
        q.reshape(B, S, K, H // K, hd), kn, vn, pos, tables.long(), fb,
        sk, sv, r * per, NB, None,
        (tail[0, 0, :, :, c0:c0 + w].contiguous(),
         tail[1, 0, :, :, c0:c0 + w].contiguous()), sketch, c0)
        for r, ((sk, sv), (c0, w)) in enumerate(zip(shards,
                                                    _cols(32, n)))])
    for o in outs:
        o = o.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd) @ p["attn"]["wo"]
        _close(o, want, 1e-5)
    assert torch.equal(torch.cat([s[0] for s in shards]), wk)
    assert torch.equal(torch.cat([s[1] for s in shards]), wv)


# ---------------------------------------------------------------------------
# Emulated ranks: expert-parallel MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_moe_rank_expert_parallel_is_the_gathered_form(n):
    """Reduced deepseek-moe (E 8) in f32 on n emulated expert ranks, each
    with E / n experts: the output and every expert gradient bitwise the
    gathered ``moe_ffn``'s (each expert's rows and products are the
    same), the input's gradient within 1e-6 x max (its experts' shares
    summed in another order)."""
    cfg = reduced_config("deepseek-moe-16b")
    E = cfg.moe.num_experts
    p = tf.tree_map(lambda t: t.float(),
                    tf.init_params(cfg, seed=3, device="cpu"))["blocks"][0]
    p = p["moe"]
    g = torch.Generator().manual_seed(n)
    x = torch.randn((2, 48, cfg.d_model), generator=g)
    gy = torch.randn((2, 48, cfg.d_model), generator=g)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xa = x.clone().requires_grad_(True)
    want, aux = moe.moe_ffn(leaves, xa, cfg, with_aux=True)
    wg = torch.autograd.grad((want * gy).sum() + aux,
                             [xa] + [leaves[k] for k in moe.EXPERT_LEAVES])
    xb = x.clone().requires_grad_(True)
    ex = {k: p[k].clone().requires_grad_(True) for k in moe.EXPERT_LEAVES}
    El = E // n
    bodies = []
    for r in range(n):
        lp = {k: v for k, v in p.items() if k not in moe.EXPERT_LEAVES}
        lp.update({k: ex[k][r * El:(r + 1) * El] for k in ex})
        bodies.append(moe.moe_rank(lp, xb, cfg, with_aux=True,
                                   expert0=r * El))
    outs = ranks.run_ranks(bodies)
    for y, a in outs:
        assert torch.equal(y, want) and torch.equal(a, aux)
    y, a = outs[0]
    gg = torch.autograd.grad((y * gy).sum() + a,
                             [xb] + [ex[k] for k in moe.EXPERT_LEAVES])
    _close(gg[0], wg[0], 1e-6)
    for got, w in zip(gg[1:], wg[1:]):
        assert torch.equal(got, w)


def test_expert_parallel_rule_is_the_reference_s():
    from repro.configs.registry import get_config as ref_get
    from repro.launch import shardings as RS
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch import shardings as SH
    from repro_torch.models.sharding import norm_entry
    for arch in ARCH_IDS:
        for multi_pod in (False, True):
            rules = SH.make_rules(get_config(arch), "train", False,
                                  multi_pod)[0]
            want = RS.make_rules(ref_get(arch), "train", False,
                                 multi_pod)[0]
            for k in ("experts", "moe_groups"):
                assert norm_entry(rules[k]) == norm_entry(want[k]), (arch, k)
    assert SH.expert_parallel(get_config("deepseek-moe-16b"))
    assert not SH.expert_parallel(get_config("granite-moe-3b-a800m"))


# ---------------------------------------------------------------------------
# The dry run of deepseek-moe train_4k on the 2x16x16 mesh
# ---------------------------------------------------------------------------


def _ref_param_bytes(cfg, shape) -> int:
    """Per-device parameter bytes of the reference's specs (multi-pod)."""
    from repro.launch import shardings as RS
    from repro.models import model as RM
    from repro_torch.models import sharding as Sh
    sizes = {"data": 16, "model": 16, "pod": 2}
    rules, strat = RS.make_rules(cfg, shape.kind, False, True,
                                 shape.global_batch)
    ps = RM.param_specs(cfg)
    specs = RS.build_param_pspecs(cfg, ps, rules, strat)
    sl = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(ps), sl):
        spec = Sh.norm_spec(tuple(spec))
        n = 1
        for i, dd in enumerate(leaf.shape):
            e = spec[i] if i < len(spec) else None
            n *= dd // Sh.axes_size(e, sizes)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("form", ["expert_parallel", "gathered"])
def test_dryrun_deepseek_train_4k_keeps_experts_on_model(form, monkeypatch):
    """One layer, batch 32 x 256, on the 2x16x16 mesh: argument bytes are
    the reference's per-device parameter bytes plus this rank's tokens
    and labels, exactly; no all-gather over rank 0's ``model`` group
    carries an expert leaf's shard (E / 16 experts), while the gathered
    form (the rules' ``experts`` unset) has one for each leaf."""
    from repro.configs.base import SHAPE_BY_NAME as REF_SHAPES
    from repro.configs.registry import get_config as ref_get
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as SH
    if form == "gathered":
        orig = SH.make_rules

        def no_ep(*a, **k):
            rules, strat = orig(*a, **k)
            return dict(rules, experts=None), strat
        monkeypatch.setattr(SH, "make_rules", no_ep)
    cell = dryrun.run_cell("deepseek-moe-16b", "train_4k", True, layers=1,
                           batch=32, seq=256, sites=True)
    assert cell["status"] == "ok", cell.get("error")
    rcfg = dataclasses.replace(ref_get("deepseek-moe-16b"), num_layers=1)
    rshape = dataclasses.replace(REF_SHAPES["train_4k"], global_batch=32,
                                 seq_len=256)
    mem = cell["memory"]
    assert mem["param_bytes_per_device"] == _ref_param_bytes(rcfg, rshape)
    assert mem["argument_bytes_per_device"] == \
        mem["param_bytes_per_device"] + 2 * 256 * 8
    cfg = get_config("deepseek-moe-16b")
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    el = E // 16
    shards = {(el, d // 16, f), (el, d, f), (el, f // 16, d), (el, f, d)}
    model = list(range(16))        # rank 0's group of the model axis
    hits = [c for c in cell["collective_list"]
            if c[0] == "all-gather" and list(c[1]) == model and c[2]
            and tuple(c[2][0]) in shards]
    if form == "expert_parallel":
        assert hits == []
        assert any(c[0] == "all-gather" and list(c[1]) != model
                   and c[2] and tuple(c[2][0]) in shards
                   for c in cell["collective_list"])
    else:
        assert len(hits) >= 3
