"""Port parity: the plain version of the sketched-moment update
(``repro_torch/kernels/ref.py:sketch_update_ref``), the signed CSVec and
the dispatch of ``sketch_update_op`` against the JAX package on the CPU.

Tolerances.  Hashes, buckets and signs are integers: bitwise.  Tables
and estimates are f32 sums of the same terms in a possibly different
order (XLA's scatter against torch's ``scatter_add_``, and the Pallas
kernel's one-hot contraction), so they agree to f32 rounding: rtol and
atol 1e-5, the reference's own kernel-vs-oracle tolerance for values of
order 1.  The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import sketch_update_ref as jax_sketch_update_ref
from repro.kernels.sketch_update import sketch_update as jax_sketch_update
from repro.sketch import csvec as ref_csvec
from repro.sketch import hashing as ref_hashing
from repro_torch.kernels import ops, ref
from repro_torch.sketch import csvec, hashing

# tiny tensors: one intra-op thread keeps the pytest-xdist workers from
# oversubscribing the CPU
torch.set_num_threads(1)

# (n, C, R): tests/test_sketch_opt.py's kernel shapes
SHAPES = [(1000, 300, 3), (4096, 512, 3), (700, 128, 4), (8192, 640, 2)]


def _inputs(n, C, R):
    rng = np.random.RandomState(n)
    g = rng.randn(n).astype(np.float32)
    mt = rng.randn(R, C).astype(np.float32)
    vt = np.abs(rng.randn(R, C)).astype(np.float32)
    cm = ref_hashing.make_coeffs(n + 3, R)
    cv = ref_hashing.make_coeffs(n + 4, R)
    return g, mt, vt, np.asarray(cm), np.asarray(cv)


def _port(g, mt, vt, cm, cv):
    t = lambda a: torch.as_tensor(a)
    return ref.sketch_update_ref(t(g), t(mt), t(vt),
                                 t(cm.astype(np.int64)),
                                 t(cv.astype(np.int64)), 0.9, 0.95)


@pytest.mark.parametrize("against", ["pallas_interpret", "jnp_ref"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_reference(shape, against):
    g, mt, vt, cm, cv = _inputs(*shape)
    j = [jnp.asarray(a) for a in (g, mt, vt, cm, cv)]
    if against == "pallas_interpret":
        want = jax_sketch_update(*j, b1=0.9, b2=0.95, bI=256, bC=128,
                                 interpret=True)
    else:
        want = jax_sketch_update_ref(*j, 0.9, 0.95)
    got = _port(g, mt, vt, cm, cv)
    for name, a, b in zip(("new_m", "new_v", "m_hat", "v_hat"), want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("rows", [2, 3, 4])
def test_signed_query_is_numpy_median(rows):
    """The signed estimate is jnp.median over rows: for an even row count
    the mean of the two middle values, not torch.median's lower one."""
    rng = np.random.RandomState(rows)
    table = rng.randn(rows, 97).astype(np.float32)
    idx = rng.randint(0, 1 << 30, 500).astype(np.int32)
    rsk = ref_csvec.CSVec(table=jnp.asarray(table),
                          coeffs=ref_hashing.cached_coeffs(5, rows), d=1 << 30,
                          signed=True)
    psk = csvec.CSVec(table=torch.as_tensor(table),
                      coeffs=hashing.cached_coeffs(5, rows), d=1 << 30,
                      signed=True)
    bk, sg = ref_hashing.row_buckets_signs(rsk.coeffs, idx, 97, True)
    est = np.take_along_axis(table, np.asarray(bk), axis=1) * np.asarray(sg)
    want = np.asarray(jnp.median(jnp.asarray(est), axis=0))
    np.testing.assert_array_equal(np.asarray(ref_csvec.query(rsk, idx)),
                                  want)
    np.testing.assert_allclose(csvec.query(psk, torch.as_tensor(idx)).numpy(),
                               want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        ref.median_rows(torch.as_tensor(est)).numpy(), want, rtol=1e-6,
        atol=1e-7)


def test_hashes_past_two_to_the_31():
    """A yi-9b FFN leaf has 2,164,260,864 elements: the port hashes the
    64-bit index by its low 32 bits, as the reference hashes uint32."""
    C = 180_355_072                         # yi-9b w_gate, ratio 4, rows 3
    rng = np.random.RandomState(0)
    idx = np.concatenate([
        [2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2_119_172_096,
         2_164_260_863, 2 ** 32 - 1],
        rng.randint(2 ** 31, 2 ** 32, 3000, dtype=np.int64)])
    coeffs = ref_hashing.cached_coeffs(77, 3)
    cn = np.asarray(coeffs)
    tc = hashing.cached_coeffs(77, 3)
    u = jnp.asarray(idx.astype(np.uint32))
    t = torch.as_tensor(idx)
    for r in range(3):
        np.testing.assert_array_equal(
            hashing.bucket_hash(t, tc[r, 0], tc[r, 1], C).numpy(),
            np.asarray(ref_hashing.bucket_hash(u, cn[r, 0], cn[r, 1], C)))
        np.testing.assert_array_equal(
            hashing.sign_hash(t, tc[r, 2], tc[r, 3]).numpy(),
            np.asarray(ref_hashing.sign_hash(u, cn[r, 2], cn[r, 3])))
    rb, rs = ref_hashing.row_buckets_signs(coeffs, u, C, True)
    pb, ps = hashing.row_buckets_signs(tc, t, C, True)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))


def test_pieces_at_offsets_equal_one_flat_call():
    n, C, R = 6000, 512, 3
    g, mt, vt, cm, cv = _inputs(n, C, R)
    t = torch.as_tensor
    cm_t, cv_t = t(cm.astype(np.int64)), t(cv.astype(np.int64))
    flat_m, flat_v = t(mt).clone(), t(vt).clone()
    [(fm_hat, fv_hat)] = ops.sketch_update_op(
        [(t(g), 0)], flat_m, flat_v, cm_t, cv_t, b1=0.9, b2=0.95)
    want = ref.sketch_update_ref(t(g), t(mt), t(vt), cm_t, cv_t, 0.9, 0.95)
    for a, b in zip((flat_m, flat_v, fm_hat, fv_hat), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    pm, pv = t(mt).clone(), t(vt).clone()
    cuts = [0, 1000, 1001, 4500, n]
    pieces = [(t(g[a:b]), a) for a, b in zip(cuts, cuts[1:])]
    est = list(ops.sketch_update_op(pieces, pm, pv, cm_t, cv_t, b1=0.9,
                                    b2=0.95))
    torch.testing.assert_close(pm, flat_m, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(pv, flat_v, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([e[0] for e in est]), fm_hat,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([e[1] for e in est]), fv_hat,
                               rtol=1e-6, atol=1e-6)


def test_piece_past_two_to_the_31_matches_reference_csvec():
    """One piece of a stacked leaf at offset 47 * n (layer 47 of a yi-9b
    FFN leaf, scaled down): its table contributions and estimates equal
    the reference CSVec's at the same uint32 coordinates."""
    n, C, R = 3000, 256, 3
    offset = 2_119_172_096
    g, mt, vt, cm, cv = _inputs(n, C, R)
    coords = (offset + np.arange(n)).astype(np.uint32)
    rm = ref_csvec.accumulate_coords(ref_csvec.CSVec(
        table=jnp.zeros((R, C)), coeffs=jnp.asarray(cm), d=2 ** 32,
        signed=True), coords, g)
    rv = ref_csvec.accumulate_coords(ref_csvec.CSVec(
        table=jnp.zeros((R, C)), coeffs=jnp.asarray(cv), d=2 ** 32,
        signed=False), coords, g * g)
    new_m = 0.9 * mt + (1.0 - 0.9) * np.asarray(rm.table)
    new_v = 0.95 * vt + (1.0 - 0.95) * np.asarray(rv.table)
    m_hat = ref_csvec.query(ref_csvec.CSVec(
        table=jnp.asarray(new_m), coeffs=jnp.asarray(cm), d=2 ** 32,
        signed=True), coords)
    v_hat = ref_csvec.query(ref_csvec.CSVec(
        table=jnp.asarray(new_v), coeffs=jnp.asarray(cv), d=2 ** 32,
        signed=False), coords)
    t = torch.as_tensor
    pm, pv = t(mt).clone(), t(vt).clone()
    [(pm_hat, pv_hat)] = ops.sketch_update_op(
        [(t(g), offset)], pm, pv, t(cm.astype(np.int64)),
        t(cv.astype(np.int64)), b1=0.9, b2=0.95)
    for a, b in ((pm, new_m), (pv, new_v), (pm_hat, m_hat),
                 (pv_hat, v_hat)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_use_kernel_on_cpu_tensors_raises():
    g, mt, vt, cm, cv = _inputs(64, 32, 3)
    t = torch.as_tensor
    args = ([(t(g), 0)], t(mt), t(vt), t(cm.astype(np.int64)),
            t(cv.astype(np.int64)))
    with pytest.raises(ValueError, match="CUDA"):
        ops.sketch_update_op(*args, b1=0.9, b2=0.95, use_kernel=True)
    from repro_torch.kernels.sketch_update import sketch_update
    with pytest.raises(ValueError, match="CUDA"):
        sketch_update(*args, b1=0.9, b2=0.95)
