"""Port parity of the slabbed sketch_update and the tensor-core tail_scores
on the CPU, against the JAX package.

* The fused form's plain version (``ref.sketch_apply_ref``: accumulate,
  retrieve, ``sketched_leaf_update``), reached through the sketched
  optimizer, against ``repro/sketch/optimizer.py:sketched_adamw_update``
  on reduced yi-9b with every leaf of 64 elements or more sketched.
  Tolerances as tests/test_torch_train.py: params within one bf16 ulp
  (rtol 2^-7, atol 2^-9 x max|param|), tables rtol 1e-5 and atol 1e-5 x
  max|table| (f32 sums of the same terms in another order).
* A CPU model of the slabbed accumulate's grouping (``_slabbed_model``:
  the tables scaled first, the groups of ``plan_groups`` in order, each
  term scaled on its own; within a slab the kernel's order varies from run
  to run, the model takes index order) against the plain sum and the JAX
  reference, rtol and atol 1e-5; the groups of ``plan_groups`` cover
  every element once; a leaf cut into many groups equals it in one group.
* ``tail_scores`` at the CUDA kernel's tile shapes (decode tiles of 16
  query rows x 64 buckets, prefill tiles of 64 x 64, 32-feature slices;
  here full, ragged and with hd not a multiple of 8) against the JAX
  kernel in interpret mode, and the kernel's 3xTF32 split of the products
  modelled in f32, both within the card test's 1e-4 x max|estimate|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as ref_reduced
from repro.kernels import kv_sketch as rkk
from repro.kernels.ref import sketch_update_ref as jax_sketch_update_ref
from repro.models import transformer as rtf
from repro.sketch import hashing as ref_hashing
from repro.sketch import optimizer as rsk
from repro.sketch.hashing import cached_coeffs as ref_coeffs
from repro_torch.configs.registry import reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sketch_update import (MAX_SEGS, entry_bytes,
                                               plan_groups)
from repro_torch.models import bridge
from repro_torch.models import transformer as tf
from repro_torch.sketch import optimizer as sk
from repro_torch.sketch.hashing import (cached_coeffs, coeff_bits,
                                        row_buckets_signs)

torch.set_num_threads(1)

B1, B2 = 0.9, 0.95
HYPER = dict(lr=1e-2, eps=1e-8, weight_decay=0.01, bc1=0.1, bc2=0.05)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# The fused form's plain version against the JAX sketched optimizer
# ---------------------------------------------------------------------------


def _ref_leaves(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out.append((name, np.asarray(leaf.astype(jnp.float32))))
    return out


@pytest.mark.parametrize("min_elems", [64, 4096])
def test_fused_plain_version_matches_reference_optimizer(min_elems,
                                                          monkeypatch):
    cfg, tcfg = ref_reduced("yi-9b"), reduced_config("yi-9b")
    params = rtf.init_params(jax.random.PRNGKey(8), cfg)
    tparams = bridge.from_reference(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    rstate = rsk.sketched_adamw_init(params, ratio=4, rows=3,
                                     min_elems=min_elems, seed=77)
    state = sk.sketched_adamw_init(tparams, ratio=4, rows=3,
                                   min_elems=min_elems, seed=77)
    kinds = [type(m).__name__ for m in state.moments]
    names = [n for n, _ in tf.param_leaves(tparams)]
    want_norm = "SketchedMoments" if min_elems == 64 else "DenseMoments"
    assert kinds[names.index("blocks/norm1")] == want_norm
    calls = []
    apply_ref = ref.sketch_apply_ref
    monkeypatch.setattr(ref, "sketch_apply_ref",
                        lambda *a, **k: calls.append(1) or apply_ref(*a, **k))
    rng = np.random.RandomState(9)
    for _ in range(2):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.randn(*p.shape).astype(np.float32)).astype(p.dtype), params)
        params, rstate = rsk.sketched_adamw_update(g, rstate, params,
                                                   lr=1e-2)
        tg = bridge.from_reference(jax.tree.map(np.asarray, g), tcfg,
                                   device="cpu")
        tparams, state = sk.sketched_adamw_update(tg, state, tparams,
                                                  lr=1e-2)
    assert len(calls) == 2 * kinds.count("SketchedMoments")
    for (name, r), (_, pieces) in zip(_ref_leaves(params),
                                      tf.param_leaves(tparams)):
        got = (torch.stack([p.float() for p in pieces]).numpy()
               if name.startswith("blocks/") else pieces[0].float().numpy())
        np.testing.assert_allclose(got, r, rtol=2 ** -7,
                                   atol=2 ** -9 * np.abs(r).max(),
                                   err_msg=name)
    ported = bridge.opt_state_from_reference(
        jax.tree.map(np.asarray, rstate), tcfg, device="cpu")
    for a, b in zip(ported.moments, state.moments):
        if isinstance(b, sk.SketchedMoments):
            for want, got in ((a.m.table, b.m.table), (a.v.table,
                                                       b.v.table)):
                torch.testing.assert_close(
                    got, want, rtol=1e-5,
                    atol=1e-5 * want.abs().max().item())


# ---------------------------------------------------------------------------
# The slabbed accumulate's order, and its groups
# ---------------------------------------------------------------------------

# (n, C, R, gradient dtype): tests/test_sketch_opt.py's kernel shapes in
# f32, then bf16 gradients on a table row of several 2^15-cell slabs
SLAB_SHAPES = [(1000, 300, 3, np.float32), (4096, 512, 3, np.float32),
               (700, 128, 4, np.float32), (8192, 640, 2, np.float32),
               (20000, 70000, 3, "bf16")]


def _slabbed_model(pieces, m_table, v_table, coeffs_m, coeffs_v, b1, b2):
    """New (R, C) tables in the slabbed accumulate's grouping: ``b *
    table`` first, then for each group of ``plan_groups`` in order and
    each table row, the group's terms ``(1-b1) * s * g`` and ``(1-b2) *
    g^2``, each rounded to f32 on its own, added in index order."""
    R, C = m_table.shape
    new_m, new_v = b1 * m_table, b2 * v_table
    a1, a2 = (torch.tensor(1.0 - b, dtype=torch.float32) for b in (b1, b2))
    for grp in plan_groups([g.numel() for g, _ in pieces], R,
                           entry_bytes(pieces[0][0].dtype)):
        for k, s, e in grp:
            g, off = pieces[k]
            gf = g[s:e].to(torch.float32)
            idx = off + s + torch.arange(e - s, dtype=torch.int64)
            bm, sm = row_buckets_signs(coeffs_m, idx, C, signed=True)
            bv, _ = row_buckets_signs(coeffs_v, idx, C, signed=False)
            new_m.scatter_add_(1, bm.long(), sm * (a1 * gf)[None, :])
            new_v.scatter_add_(1, bv.long(),
                               (a2 * (gf * gf))[None, :].expand(R, -1))
    return new_m, new_v


def _slab_inputs(n, C, R, dt, pieces=4):
    rng = np.random.RandomState(n + R)
    g = rng.randn(n).astype(np.float32)
    if dt == "bf16":
        g = torch.tensor(g).to(torch.bfloat16).float().numpy()
    mt = rng.randn(R, C).astype(np.float32)
    vt = np.abs(rng.randn(R, C)).astype(np.float32)
    cm = ref_hashing.make_coeffs(n + 3, R)
    cv = ref_hashing.make_coeffs(n + 4, R)
    tg = _t(g) if dt != "bf16" else _t(g).to(torch.bfloat16)
    cuts = np.linspace(0, n, pieces + 1).astype(int)
    parts = [(tg[a:b], int(a)) for a, b in zip(cuts, cuts[1:])]
    return g, mt, vt, cm, cv, parts


@pytest.mark.parametrize("shape", SLAB_SHAPES)
def test_slabbed_model_matches_plain_and_reference(shape):
    n, C, R, dt = shape
    g, mt, vt, cm, cv, parts = _slab_inputs(n, C, R, dt)
    tcm, tcv = _t(cm.astype(np.int64)), _t(cv.astype(np.int64))
    got_m, got_v = _slabbed_model(parts, _t(mt), _t(vt), tcm, tcv, B1, B2)
    plain_m, plain_v = ref.sketch_accumulate_ref(parts, _t(mt), _t(vt), tcm,
                                                 tcv, B1, B2)
    want = jax_sketch_update_ref(*(jnp.asarray(a) for a in (g, mt, vt, cm,
                                                             cv)), B1, B2)
    for got, plain, jax_table in ((got_m, plain_m, want[0]),
                                  (got_v, plain_v, want[1])):
        jt = _t(jax_table)
        torch.testing.assert_close(got, plain, rtol=1e-5,
                                   atol=1e-5 * plain.abs().max().item())
        torch.testing.assert_close(got, jt, rtol=1e-5,
                                   atol=1e-5 * jt.abs().max().item())


@pytest.mark.parametrize("numels,rows,entry,budget", [
    ([45_088_768] * 48, 3, 4, 4 << 30),        # a yi-9b FFN leaf
    ([4096] * 48, 3, 4, 4 << 30),              # a norm leaf
    ([262_144_000], 3, 4, 4 << 30),            # the embedding, one piece
    ([1000, 0, 1, 3500, 1500], 3, 8, 1000 * 48),
    ([7] * 200, 2, 8, 1 << 20),                # more pieces than a launch
    ([], 3, 4, 1 << 20),
])
def test_groups_cover_every_element_once(numels, rows, entry, budget):
    groups = plan_groups(numels, rows, entry, budget)
    assert groups and all(len(g) <= MAX_SEGS for g in groups)
    cap = budget // (2 * rows * entry)
    assert all(sum(e - s for _, s, e in g) <= cap for g in groups)
    flat = [seg for g in groups for seg in g]
    seen = {k: 0 for k in range(len(numels))}
    for k, s, e in flat:                       # in order, no gaps
        assert s == seen[k] and e > s
        seen[k] = e
    assert [seen[k] for k in range(len(numels))] == list(numels)
    assert [k for k, _, _ in flat] == sorted(k for k, _, _ in flat)


def test_leaf_in_many_groups_equals_one_group(monkeypatch):
    """A work space of 1500 elements: the pieces are cut across groups;
    the tables equal the one-group model's within f32 rounding."""
    from repro_torch.kernels import sketch_update as su
    n, C, R = 6000, 512, 3
    g, mt, vt, cm, cv, parts = _slab_inputs(n, C, R, "bf16", pieces=3)
    tcm, tcv = _t(cm.astype(np.int64)), _t(cv.astype(np.int64))
    one = _slabbed_model(parts, _t(mt), _t(vt), tcm, tcv, B1, B2)
    monkeypatch.setattr(su, "WORKSPACE_BYTES", 1500 * 2 * R * 4)
    assert len(plan_groups([p.numel() for p, _ in parts], R, 4)) == 4
    many = _slabbed_model(parts, _t(mt), _t(vt), tcm, tcv, B1, B2)
    for a, b in zip(many, one):
        torch.testing.assert_close(a, b, rtol=1e-6,
                                   atol=1e-6 * b.abs().max().item())


def test_fused_pieces_equal_one_flat_call():
    """sketch_apply_op on three pieces of one vector (and its params as
    three views) equals the call with one flat piece."""
    n, C, R = 6000, 512, 3
    g, mt, vt, cm, cv, parts = _slab_inputs(n, C, R, np.float32, pieces=3)
    tcm, tcv = _t(cm.astype(np.int64)), _t(cv.astype(np.int64))
    p0 = torch.tensor(np.random.RandomState(1).randn(n)).to(torch.bfloat16)
    flat_p, flat_m, flat_v = p0.clone(), _t(mt).clone(), _t(vt).clone()
    ops.sketch_apply_op([(_t(g), 0)], [flat_p], flat_m, flat_v, tcm, tcv,
                        b1=B1, b2=B2, **HYPER)
    pp, pm, pv = p0.clone(), _t(mt).clone(), _t(vt).clone()
    views = [pp[s:s + gp.numel()] for gp, s in parts]
    ops.sketch_apply_op(parts, views, pm, pv, tcm, tcv, b1=B1, b2=B2,
                        **HYPER)
    torch.testing.assert_close(pm, flat_m, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(pv, flat_v, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(pp.float(), flat_p.float(), rtol=2 ** -8,
                               atol=0)


def test_coefficient_bits_are_cast_once():
    c = cached_coeffs(31, 3)
    bits = coeff_bits(c)
    assert bits.dtype == torch.int32 and coeff_bits(c) is bits
    want = np.asarray(ref_hashing.make_coeffs(31, 3)).view(np.int32)
    np.testing.assert_array_equal(bits.numpy(), want)
    c.copy_(cached_coeffs(32, 3))             # an in-place write recasts
    again = coeff_bits(c)
    assert again is not bits
    np.testing.assert_array_equal(
        again.numpy(), np.asarray(ref_hashing.make_coeffs(32, 3)).view(
            np.int32))


# ---------------------------------------------------------------------------
# tail_scores at the kernel's tile shapes
# ---------------------------------------------------------------------------

# (N, hd, Z, C, T): the decode tile full (16 rows, 2 bucket tiles), one
# row past it (the prefill tile, ragged in rows and buckets), hd a
# multiple of 4 but not of 8 or 32, and a prefill tile and a half
TILE_SHAPES = [(16, 64, 3, 64, 200), (17, 36, 3, 70, 300),
               (8, 72, 2, 33, 130), (96, 40, 4, 96, 256)]


def _rna_tf32(x):
    """x rounded to TF32 (10 mantissa bits), nearest, ties away from zero,
    as cvt.rna.tf32.f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_products(q, tk):
    """(Z, N, C) bucket products as the kernel forms them: each f32 input
    split into big + small TF32 parts, small*big + big*small + big*big."""
    qb = _rna_tf32(q)
    qs = _rna_tf32(q - qb)
    kb = _rna_tf32(tk)
    ks = _rna_tf32(tk - kb)
    mm = lambda a, b: torch.einsum("nh,zch->znc", a, b)
    return mm(qs, kb) + mm(qb, ks) + mm(qb, kb)


@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_tail_scores_tiles_match_reference_kernel(shape):
    N, hd, Z, C, T = shape
    rng = np.random.RandomState(N + hd)
    q = rng.randn(N, hd).astype(np.float32)
    tk = rng.randn(Z, C, hd).astype(np.float32)
    jc = ref_coeffs(21, Z)
    want = np.asarray(rkk.tail_scores(jnp.asarray(q), jnp.asarray(tk), jc,
                                      T=T, bN=16, bT=64, interpret=True))
    tol = 1e-4 * np.abs(want).max()
    cf = cached_coeffs(21, Z)
    got = ref.tail_scores_ref(_t(q)[None, None], _t(tk)[None, :, :, None],
                              cf, T)[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the 3xTF32 products through the same gather and median
    prod = _split_products(_t(q), _t(tk))
    bk, sg = row_buckets_signs(cf, torch.arange(T), C, signed=True)
    est = torch.stack([prod[z][:, bk[z].long()] * sg[z] for z in range(Z)])
    np.testing.assert_allclose(ref.median_rows(est).numpy(), want, rtol=0,
                               atol=tol)
