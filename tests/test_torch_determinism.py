"""The port's fixed-order sums on the CPU, against the JAX package.

A resumed run continues bit for bit on the card only if every float sum
of a training step adds in an order fixed by the shapes and the data.
Here, on the CPU:

* ``kernels/ref.py:sketch_accumulate_ordered_ref``, the model of the
  CUDA ``sketch_update`` accumulate's order (tables scaled, then each
  cell's terms one at a time in element order), against a sequential
  numpy loop (bitwise), against the plain version and, through numpy,
  against the reference's ``sketch_update_ref`` at its kernel shapes
  (rtol and atol 1e-5 of max|table|, the sketch_update tests' tolerance:
  the same terms summed in another order, and the plain version scales
  the sum where the kernel scales each term); and bitwise the same
  however the vector is cut into pieces, strided or not;
* ``sketch/csvec.py:index_add_ordered_`` and its users
  (``accumulate_coords`` of sketched Adagrad and the optimizer's plain
  version, TS / FCS of a dense tensor) bitwise the ``index_add_`` /
  ``scatter_add_`` forms they replace, which add in the same order on
  the CPU, and ``index_add_ordered_`` bitwise a sequential loop; the
  gradient sketch ``sketch_leaf`` (rows summed by bucket, then columns
  added at their shifts) bitwise a numpy loop of that order and within
  f32 rounding of the element-by-element form it replaces;
* ``train/determinism.py:OrderAudit`` over one training step (forward
  and backward) of each of the ten configs: no float add into shared
  targets, no device-wide float scan, no op without a deterministic CUDA
  path; and the audit flags each kind where it occurs.

The card's side (kernel launches bitwise, the ordered model bitwise the
kernel, resumed runs bitwise) is in tests/test_torch_cuda.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import sketch_update_ref as jax_sketch_update_ref
from repro.sketch import hashing as ref_hashing
from repro_torch.configs.registry import ARCH_IDS, reduced_config
from repro_torch.core import make_tensor_hashes
from repro_torch.core import sketches as core_sketches
from repro_torch.kernels import ref
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.sketch.csvec import (CSVec, accumulate_coords,
                                      index_add_ordered_)
from repro_torch.sketch.hashing import cached_coeffs, row_buckets_signs
from repro_torch.train import data as data_lib
from repro_torch.train import grad_compress as gcm
from repro_torch.train.determinism import OrderAudit

# the reference's kernel shapes (n, C, R): tests/test_sketch_opt.py
SHAPES = [(1000, 300, 3), (4096, 512, 3), (700, 128, 4), (8192, 640, 2)]
B1, B2 = 0.9, 0.95


def _inputs(n, C, R, dtype=np.float32):
    rng = np.random.RandomState(n)
    g = rng.randn(n).astype(np.float32)
    mt = rng.randn(R, C).astype(np.float32)
    vt = np.abs(rng.randn(R, C)).astype(np.float32)
    cm = np.asarray(ref_hashing.make_coeffs(n + 3, R))
    cv = np.asarray(ref_hashing.make_coeffs(n + 4, R))
    t = lambda a: torch.as_tensor(a)
    return (g, mt, vt, cm, cv), (t(g).to(torch.float32 if dtype == np.float32
                                         else torch.bfloat16),
                                 t(mt), t(vt), t(cm.astype(np.int64)),
                                 t(cv.astype(np.int64)))


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_ordered_model_is_a_sequential_loop(shape):
    """Bitwise numpy's f32 loop: each table times b, then for j = 0, 1,
    ... and every row, the cell += (1-b) * s * g_j (resp. (1-b) g_j^2)."""
    n, C, R = shape
    (g, mt, vt, cm, cv), (tg, tm, tv, tcm, tcv) = _inputs(n, C, R)
    got = ref.sketch_accumulate_ordered_ref([(tg, 0)], tm, tv, tcm, tcv,
                                            B1, B2)
    f = np.float32
    idx = torch.arange(n)
    bm, sm = (x.numpy() for x in row_buckets_signs(tcm, idx, C, True))
    bv, _ = (x.numpy() for x in row_buckets_signs(tcv, idx, C, False))
    m, v = mt * f(B1), vt * f(B2)
    a1, a2 = f(1.0 - B1), f(1.0 - B2)
    for j in range(n):
        for r in range(R):
            m[r, bm[r, j]] = f(m[r, bm[r, j]] + f(a1 * g[j]) * sm[r, j])
            v[r, bv[r, j]] = f(v[r, bv[r, j]] + f(a2 * f(g[j] * g[j])))
    assert np.array_equal(got[0].numpy(), m)
    assert np.array_equal(got[1].numpy(), v)


@pytest.mark.parametrize("shape", SHAPES)
def test_ordered_model_matches_the_plain_version_and_the_reference(shape):
    n, C, R = shape
    (g, mt, vt, cm, cv), (tg, tm, tv, tcm, tcv) = _inputs(n, C, R)
    om, ov = ref.sketch_accumulate_ordered_ref([(tg, 0)], tm, tv, tcm, tcv,
                                               B1, B2)
    pm, pv = ref.sketch_accumulate_ref([(tg, 0)], tm, tv, tcm, tcv, B1, B2)
    _close(om, pm)
    _close(ov, pv)
    want = jax_sketch_update_ref(*(jnp.asarray(a) for a in
                                   (g, mt, vt, cm, cv)), B1, B2)
    _close(om, torch.as_tensor(np.array(want[0])))
    _close(ov, torch.as_tensor(np.array(want[1])))


def test_ordered_model_does_not_depend_on_the_pieces():
    """One vector as one piece, as ragged pieces, and a (rows, cols)
    block of it as one strided piece or a contiguous piece a row: the
    same terms in the same element order, so the same bits."""
    (_, _, _, _, _), (g, tm, tv, tcm, tcv) = _inputs(6000, 700, 3)
    one = ref.sketch_accumulate_ordered_ref([(g, 11)], tm, tv, tcm, tcv,
                                            B1, B2)
    cuts = [0, 7, 1000, 1001, 4500, 6000]
    parts = [(g[a:b], 11 + a) for a, b in zip(cuts, cuts[1:])]
    got = ref.sketch_accumulate_ordered_ref(parts, tm, tv, tcm, tcv, B1, B2)
    assert all(torch.equal(x, y) for x, y in zip(one, got))
    rows, w, cols = 40, 30, 100          # a block of 40 rows of 30 of 100
    blk = g[:rows * w].reshape(rows, w)
    strided = ref.sketch_accumulate_ordered_ref(
        [(blk, 500, w, cols)], tm, tv, tcm, tcv, B1, B2)
    per_row = ref.sketch_accumulate_ordered_ref(
        [(blk[r], 500 + r * cols) for r in range(rows)], tm, tv, tcm, tcv,
        B1, B2)
    assert all(torch.equal(x, y) for x, y in zip(strided, per_row))
    bf = ref.sketch_accumulate_ordered_ref(
        [(g.to(torch.bfloat16), 11)], tm, tv, tcm, tcv, B1, B2)
    plain = ref.sketch_accumulate_ref([(g.to(torch.bfloat16), 11)], tm, tv,
                                      tcm, tcv, B1, B2)
    for x, y in zip(bf, plain):
        _close(x, y)


@pytest.mark.parametrize("n,J", [(100_000, 1000), (3000, 7), (1, 5)])
def test_index_add_ordered_is_a_sequential_loop(n, J):
    rng = np.random.RandomState(n)
    pos = rng.randint(0, J, n)
    val = rng.randn(n).astype(np.float32)
    want = np.zeros(J, np.float32)
    for p, x in zip(pos, val):
        want[p] = np.float32(want[p] + x)
    out = torch.zeros(J)
    index_add_ordered_(out, torch.as_tensor(pos), torch.as_tensor(val))
    assert np.array_equal(out.numpy(), want)


def test_sketch_leaf_adds_rows_by_bucket_then_columns():
    """``sketch_leaf``'s order, bitwise a numpy loop: each row times s1
    summed into its bucket h1 in row order, then column j of the sums
    times s2(j) added at h1 + h2(j); and within f32 rounding (rtol and
    atol 1e-6 of max|sketch|, test_torch_grad_compress.py's tolerance) of
    the element-by-element ``index_add_`` form it replaces."""
    c = gcm.LeafCodec(leaf_id=3, I1=4000, k=16, Jt=4015, pad=0)
    tables = gcm.codec_hashes(c, 7, 2, torch.device("cpu"))
    g = torch.randn(c.I1 * c.k, generator=torch.Generator().manual_seed(0))
    got = gcm.sketch_leaf([g], c, tables)
    h1, s1, h2, s2 = (t.numpy() for t in tables)
    rows = g.numpy().reshape(c.I1, c.k)
    sums = {}
    for i in range(c.I1):
        row = (rows[i] * s1[i]).astype(np.float32)
        sums[h1[i]] = (sums[h1[i]] + row).astype(np.float32) \
            if h1[i] in sums else row
    want = np.zeros(c.Jt, np.float32)
    for j in range(c.k):
        for b, v in sums.items():
            want[b + h2[j]] = np.float32(want[b + h2[j]] + v[j] * s2[j])
    assert np.array_equal(got.numpy(), want)
    old = torch.zeros(c.Jt)
    for x, pos, sign in gcm._chunks([g], c, tables):
        old.index_add_(0, pos, x.float() * sign)
    torch.testing.assert_close(got, old, rtol=1e-6,
                               atol=1e-6 * old.abs().max().item())


def test_sketch_leaf_does_not_depend_on_the_pieces_cut_rows_aside():
    """The same leaf as one piece and as pieces whose edges cut rows: the
    cut rows' elements add one at a time, the rest as whole rows, all
    within f32 rounding of one another; two calls give the same bits."""
    c = gcm.LeafCodec(leaf_id=1, I1=5000, k=16, Jt=5015, pad=7)
    tables = gcm.codec_hashes(c, 3, 0, torch.device("cpu"))
    n = c.I1 * c.k - c.pad
    g = torch.randn(n, generator=torch.Generator().manual_seed(1))
    one = gcm.sketch_leaf([g], c, tables)
    cut = [g[:1001], g[1001:50_003], g[50_003:]]
    parts = gcm.sketch_leaf(cut, c, tables)
    torch.testing.assert_close(parts, one, rtol=1e-6,
                               atol=1e-6 * one.abs().max().item())
    assert torch.equal(parts, gcm.sketch_leaf(cut, c, tables))


@pytest.mark.parametrize("signed", [True, False])
def test_accumulate_coords_is_bitwise_its_scatter_add_form(signed):
    gen = torch.Generator().manual_seed(1)
    idx = torch.randint(0, 1 << 31, (200_000,), generator=gen)
    vals = torch.randn(200_000, generator=gen)
    coeffs = cached_coeffs(5, 3)
    got = CSVec(torch.zeros(3, 1000), coeffs, 0, signed)
    accumulate_coords(got, idx, vals)
    bk, sg = row_buckets_signs(coeffs, idx, 1000, signed)
    want = torch.zeros(3, 1000).scatter_add_(1, bk.long(), sg * vals[None])
    assert torch.equal(got.table, want)


@pytest.mark.parametrize("kind", ["ts", "fcs"])
def test_general_sketches_are_bitwise_their_index_add_form(kind):
    gen = torch.Generator().manual_seed(2)
    dims = (30, 20, 25)
    hashes = make_tensor_hashes(dims, [64, 50, 40], 3, generator=gen,
                                device="cpu")
    T = torch.randn(dims, generator=gen)
    got = getattr(core_sketches, f"{kind}_general")(T, hashes)
    D, N = 3, 3
    out_len = got.shape[1]
    pos = torch.zeros((D, 1, 1, 1), dtype=torch.int64)
    sign = torch.ones((D, 1, 1, 1))
    for n, mh in enumerate(hashes):
        shape = (D,) + tuple(mh.I if m == n else 1 for m in range(N))
        pos = pos + mh.h.reshape(shape)
        sign = sign * mh.s.reshape(shape).float()
    if kind == "ts":
        pos = pos % out_len
    pos = pos + out_len * torch.arange(D).reshape(D, 1, 1, 1)
    want = torch.zeros(D * out_len).index_add_(0, pos.reshape(-1),
                                               (sign * T).reshape(-1))
    assert torch.equal(got, want.reshape(D, out_len))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_adds_in_a_fixed_order(arch):
    """One forward and backward of the reduced config under
    ``OrderAudit``: the backward of every gather (embedding rows, the
    MoE dispatch and combine, the loss's gold logits) lands in sorted
    index puts or in scatter-adds with one term a target, so nothing is
    flagged; and the step does run such ops."""
    cfg = reduced_config(arch)
    params = tf.init_params(cfg, seed=0, device="cpu")
    batch = data_lib.make_batch(cfg, 0, 2, 32, 0, "cpu")
    with OrderAudit() as audit:
        M.make_train_step(cfg)(params, batch)
    assert audit.flagged == []
    assert audit.counts["scatter_add"] > 0           # the loss's gather
    assert audit.counts["mm"] + audit.counts["bmm"] > 0


def test_order_audit_flags_each_kind():
    x = torch.zeros(10)
    with OrderAudit() as audit:
        x.index_add(0, torch.tensor([1, 1]), torch.ones(2))       # shared
        x.index_add(0, torch.tensor([1, 2]), torch.ones(2))       # distinct
        torch.zeros(3, 4).scatter_add(1, torch.tensor([[0, 0]]),
                                      torch.ones(1, 2))           # shared
        torch.zeros(3, 4).scatter_add(1, torch.tensor([[0], [0]]),
                                      torch.ones(2, 1))           # distinct
        torch.zeros(4, dtype=torch.int64).index_add(
            0, torch.tensor([1, 1]), torch.ones(2, dtype=torch.int64))
        torch.cumsum(torch.ones(8), 0)                            # whole
        torch.cumsum(torch.ones(2, 8), 1)                         # per row
        x.index_put_((torch.tensor([3, 3]),), torch.ones(2),
                     accumulate=True)                             # sorted
    assert [(n, s) for n, _, s in audit.flagged] == [
        ("index_add", (10,)), ("scatter_add", (3, 4)), ("cumsum", (8,))]


def test_resume_keeps_the_checkpointed_tables_bitwise(tmp_path):
    """Reduced yi-9b with sketched AdamW (every leaf of >= 4096 elements
    sketched) and FCS compression, crashed at step 3 after a checkpoint
    at 2 and resumed: losses, params and tables bitwise the straight
    run's (the CPU form of the card's check in tests/test_torch_cuda.py,
    ``test_resume_is_bitwise_on_the_card``)."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import train
    cfg = dataclasses.replace(reduced_config("yi-9b"), d_model=128,
                              d_ff=256)
    cfg = dataclasses.replace(cfg, sketch=dataclasses.replace(
        cfg.sketch, opt_state_ratio=4, opt_state_min_elems=4096))
    run = dict(steps=4, batch=2, seq=32, lr=1e-3, grad_compression=True,
               log_every=100, log_fn=lambda *_: None, device="cpu")
    final = {}

    def keep(tag):
        def hook(step, params, grads, opt):
            if step == 3:
                final[tag] = ckpt._leaves({"params": params, "opt": opt})
        return hook

    straight = train(cfg, on_grads=keep("a"), **run)
    d = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="injected crash at step 3"):
        train(cfg, ckpt_dir=d, ckpt_every=2, crash_at_step=3, **run)
    resumed = train(cfg, ckpt_dir=d, ckpt_every=10, resume=True,
                    on_grads=keep("b"), **run)
    assert resumed.losses == straight.losses[2:]
    assert [n for n, _, _ in final["a"]] == [n for n, _, _ in final["b"]]
    for (n, x, _), (_, y, _) in zip(final["a"], final["b"]):
        assert (x == y) if isinstance(x, int) else torch.equal(x, y), n
