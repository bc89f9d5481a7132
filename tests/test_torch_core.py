"""Port parity: the paper core of ``repro_torch`` (core/: hashes, CS apply
and decompress, TS/HCS/FCS general and CP sketches, decompression, the
tiuu / tuuu contractions, the Kronecker and mode-contraction codecs)
against the JAX package's ``repro.core`` at reduced sizes (I <= 30,
J <= 500, D <= 3), on tensors made by numpy from a seed and the
reference's own hashes carried across by ``bridge.mode_hashes_from_
reference``.  Everything runs on CPU tensors, so every CS apply and lookup
takes the kernels' plain versions.

Tolerances.  Hash tables, buckets, signs and coefficients are integers or
+-1 and must be equal.  Lookups and medians of the same values are exact:
bitwise.  Scatters sum the same f32 terms in another order: within
1e-5 x max|value|.  Anything through an FFT (CP sketches, tiuu, tuuu, the
codecs' compress): within 1e-4 x max|value|.  The structured identities
inside the port hold at the tolerances tests/test_core_sketches.py gives
them in the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as rc
from repro.core.hashes import combined_fcs_hash as ref_combined
from repro_torch import core as pc
from repro_torch.core.hashes import combined_fcs_hash
from repro_torch.models.bridge import mode_hashes_from_reference

torch.set_num_threads(1)

DIMS = (17, 13, 11)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _hashes(dims, Js, D, seed=0):
    ref = rc.make_tensor_hashes(jax.random.PRNGKey(seed), dims, Js, D)
    return ref, mode_hashes_from_reference(ref, "cpu")


def _cp(dims, R, seed=1):
    rng = np.random.RandomState(seed)
    lam = (rng.rand(R) + 0.5).astype(np.float32)
    Us = [rng.randn(d, R).astype(np.float32) for d in dims]
    T = np.einsum("ar,br,cr,r->abc", *Us, lam).astype(np.float32)
    return lam, Us, T


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Hashes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("I,J,D,seed", [(17, 16, 3, 0), (1000, 37, 2, 5),
                                        (30, 500, 1, 9)])
def test_mode_hash_tables_bitwise(I, J, D, seed):
    ref = rc.make_mode_hash(jax.random.PRNGKey(seed), I, J, D)
    port = mode_hashes_from_reference(ref, "cpu")
    np.testing.assert_array_equal(port.h.numpy(), np.asarray(ref.h))
    np.testing.assert_array_equal(port.s.numpy(), np.asarray(ref.s))
    np.testing.assert_array_equal(port.coeffs.numpy(), np.asarray(ref.coeffs))
    assert (port.J, port.D, port.I) == (ref.J, ref.D, ref.I)
    # the bucket links chain each bucket's entries in increasing i (one
    # tile at these I), bit 15 the sign
    lk = port.links.numpy().astype(np.int64) & 0xffff
    h, s = np.asarray(ref.h), np.asarray(ref.s)
    for d in range(D):
        for i in range(I):
            later = np.flatnonzero(h[d, i + 1:] == h[d, i])
            assert bool(lk[d, i] & 0x800) == (later.size > 0)
            if later.size:
                assert lk[d, i] & 0x7ff == i + 1 + later[0]
            assert bool(lk[d, i] & 0x1000) == bool(np.any(h[d, :i] == h[d, i]))
            assert (lk[d, i] >> 15) == (s[d, i] < 0)


def test_port_draws_hashes_in_range_from_a_generator():
    g = torch.Generator().manual_seed(3)
    hs = pc.make_tensor_hashes((40, 50), [7, 300], D=4, generator=g,
                               device="cpu")
    for mh, (I, J) in zip(hs, ((40, 7), (50, 300))):
        assert mh.h.shape == (4, I) and mh.h.dtype == torch.int32
        assert int(mh.h.min()) >= 0 and int(mh.h.max()) < J
        assert set(mh.s.unique().tolist()) <= {-1.0, 1.0}
        again = pc.mode_hash_from_coeffs(mh.coeffs, I, J, "cpu")
        assert torch.equal(again.h, mh.h) and torch.equal(again.s, mh.s)
    assert pc.fcs_sketch_len([16, 16, 16]) == 46
    assert pc.storage_bytes_tabulated(hs) == rc.storage_bytes_tabulated(
        tuple(rc.make_tensor_hashes(jax.random.PRNGKey(0), (40, 50), 7, 4)))
    assert pc.storage_bytes_cs_long((40, 50), 4) == rc.storage_bytes_cs_long(
        (40, 50), 4)


# ---------------------------------------------------------------------------
# Count sketch apply and decompress
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 3])
def test_cs_apply_family_matches_reference(D):
    ref_h, port_h = _hashes((30, 20), [64, 50], D)
    rng = np.random.RandomState(D)
    x = rng.randn(30).astype(np.float32)
    X = rng.randn(30, 5).astype(np.float32)
    Xb = rng.randn(2, 3, 30).astype(np.float32)
    _close(pc.cs_apply(_t(x), port_h[0]),
           rc.cs_apply(jnp.asarray(x), ref_h[0]), 1e-5)
    _close(pc.cs_apply_cols(_t(X), port_h[0]),
           rc.cs_apply_cols(jnp.asarray(X), ref_h[0]), 1e-5)
    _close(pc.cs_apply_batch(_t(Xb), port_h[0]),
           rc.cs_apply_batch(jnp.asarray(Xb), ref_h[0]), 1e-5)


@pytest.mark.parametrize("D", [2, 3])
def test_cs_unsketch_matches_reference_bitwise(D):
    """Signed lookups and numpy's median (the middle pair averaged at even
    D, where torch.median would return the lower one)."""
    ref_h, port_h = _hashes((30,), [12], D, seed=2)
    y = np.random.RandomState(7).randn(D, 12).astype(np.float32)
    got = pc.cs_unsketch(_t(y), port_h[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        rc.cs_unsketch(jnp.asarray(y), ref_h[0])))
    idx = np.array([3, 0, 29, 3], np.int64)
    np.testing.assert_array_equal(
        pc.cs_unsketch_at(_t(y), port_h[0], _t(idx)).numpy(),
        np.asarray(rc.cs_unsketch_at(jnp.asarray(y), ref_h[0],
                                     jnp.asarray(idx))))
    est = torch.from_numpy(np.random.RandomState(1).randn(D, 9)
                           .astype(np.float32))
    np.testing.assert_array_equal(pc.median_combine(est).numpy(),
                                  np.median(est.numpy(), axis=0))
    np.testing.assert_array_equal(pc.median_combine(est.T, axis=1).numpy(),
                                  np.median(est.numpy(), axis=0))
    if D % 2 == 0:
        assert not torch.equal(pc.median_combine(est),
                               est.median(dim=0).values)


# ---------------------------------------------------------------------------
# General and CP sketches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ts", "fcs", "hcs"])
def test_general_sketches_match_reference(kind):
    ref_h, port_h = _hashes(DIMS, [16, 9, 12], 3)
    _, _, T = _cp(DIMS, 4)
    got = getattr(pc, f"{kind}_general")(_t(T), port_h)
    want = getattr(rc, f"{kind}_general")(jnp.asarray(T), ref_h)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kind", ["ts", "fcs", "hcs"])
def test_cp_sketches_match_reference(kind):
    ref_h, port_h = _hashes(DIMS, 16, 3, seed=4)
    lam, Us, _ = _cp(DIMS, 4, seed=5)
    got = getattr(pc, f"{kind}_cp")(_t(lam), [_t(U) for U in Us], port_h)
    want = getattr(rc, f"{kind}_cp")(jnp.asarray(lam),
                                     [jnp.asarray(U) for U in Us], ref_h)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("kind", ["fcs", "hcs"])
def test_decompress_entry_matches_reference_bitwise(kind):
    ref_h, port_h = _hashes(DIMS, [16, 9, 12], 3, seed=6)
    _, _, T = _cp(DIMS, 3, seed=7)
    sk = np.asarray(getattr(rc, f"{kind}_general")(jnp.asarray(T), ref_h))
    rng = np.random.RandomState(8)
    idx = [rng.randint(0, d, (5, 1)) for d in DIMS[:2]] + [
        rng.randint(0, DIMS[2], (1, 4))]
    got = getattr(pc, f"{kind}_decompress_entry")(
        _t(sk), port_h, [_t(i) for i in idx])
    want = getattr(rc, f"{kind}_decompress_entry")(
        jnp.asarray(sk), ref_h, [jnp.asarray(i) for i in idx])
    assert got.shape == (3, 5, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Contractions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fcs", "ts"])
def test_tiuu_tuuu_per_repetition_match_reference(kind):
    dims = (23, 23, 23)
    ref_h, port_h = _hashes(dims, 200, 3, seed=10)
    _, _, T = _cp(dims, 3, seed=11)
    u = np.random.RandomState(12).randn(23).astype(np.float32)
    u /= np.linalg.norm(u)
    sk = np.asarray(getattr(rc, f"{kind}_general")(jnp.asarray(T), ref_h))
    for fn in ("tiuu", "tuuu"):
        got = getattr(pc, f"{kind}_{fn}")(_t(sk), _t(u), port_h)
        want = getattr(rc, f"{kind}_{fn}")(jnp.asarray(sk), jnp.asarray(u),
                                           ref_h)
        assert got.shape == ((3, 23) if fn == "tiuu" else (3,))
        _close(got, want, 1e-4)
    # a batch of vectors: each row the single-vector contraction
    U = np.random.RandomState(13).randn(4, 23).astype(np.float32)
    for fn in ("tiuu", "tuuu"):
        f = getattr(pc, f"{kind}_{fn}")
        batch = f(_t(sk), _t(U), port_h)
        single = torch.stack([f(_t(sk), _t(r), port_h) for r in U], dim=1)
        _close(batch, single, 1e-5)


def test_kron_codec_matches_reference():
    shA, shB = (6, 5), (4, 7)
    ref_h, port_h = _hashes(shA + shB, 30, 3, seed=14)
    rng = np.random.RandomState(15)
    A = rng.uniform(-5, 5, shA).astype(np.float32)
    B = rng.uniform(-5, 5, shB).astype(np.float32)
    sk = pc.fcs_kron_compress(_t(A), _t(B), port_h)
    want = np.asarray(rc.fcs_kron_compress(jnp.asarray(A), jnp.asarray(B),
                                           ref_h))
    _close(sk, want, 1e-4)
    got = pc.fcs_kron_decompress(_t(want), port_h, shA, shB)
    assert got.shape == (24, 35)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        rc.fcs_kron_decompress(jnp.asarray(want), ref_h, shA, shB)))


def test_contraction_codec_matches_reference():
    shA, shB, out = (5, 4, 6), (6, 3, 5), (5, 4, 3, 5)
    ref_h, port_h = _hashes(out, 40, 3, seed=16)
    rng = np.random.RandomState(17)
    A = rng.uniform(0, 10, shA).astype(np.float32)
    B = rng.uniform(0, 10, shB).astype(np.float32)
    sk = pc.fcs_contraction_compress(_t(A), _t(B), port_h)
    want = np.asarray(rc.fcs_contraction_compress(jnp.asarray(A),
                                                  jnp.asarray(B), ref_h))
    _close(sk, want, 1e-4)
    got = pc.fcs_contraction_decompress(_t(want), port_h, out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        rc.fcs_contraction_decompress(jnp.asarray(want), ref_h, out)))


# ---------------------------------------------------------------------------
# Structured identities inside the port (tests/test_core_sketches.py:74-104)
# ---------------------------------------------------------------------------


def _identity(name):
    g = torch.Generator().manual_seed(21)
    hs = pc.make_tensor_hashes(DIMS, 16, 3, generator=g, device="cpu")
    lam, Us, T = (_t(a) if not isinstance(a, list) else [_t(u) for u in a]
                  for a in _cp(DIMS, 4, seed=22))
    if name == "fcs_equals_structured_long_cs":
        hc, sc = combined_fcs_hash(hs)
        Jt = pc.fcs_sketch_len([mh.J for mh in hs])
        want = torch.stack([torch.zeros(Jt).index_add_(
            0, hc[d].long(), sc[d] * T.reshape(-1)) for d in range(3)])
        return pc.fcs_general(T, hs), want, 1e-4
    if name.endswith("_cp_equals_general"):
        kind = name.split("_")[0]
        return (getattr(pc, f"{kind}_cp")(lam, Us, hs),
                getattr(pc, f"{kind}_general")(T, hs), 3e-3)
    # tiuu's z-trick equals the explicit <FCS(T), FCS(e_i o u o u)>
    hs = pc.make_tensor_hashes((11, 11, 11), 64, 3, generator=g,
                               device="cpu")
    _, _, T = _cp((11, 11, 11), 2, seed=23)
    T = _t(T)
    u = torch.randn(11, generator=g)
    u = u / u.norm()
    sk = pc.fcs_general(T, hs)
    direct = torch.stack([
        (sk * pc.fcs_cp(torch.ones(1), [torch.eye(11)[i][:, None],
                                        u[:, None], u[:, None]], hs)).sum(-1)
        for i in range(11)], dim=1)
    return pc.fcs_tiuu(sk, u, hs), direct, 2e-3


@pytest.mark.parametrize("name", [
    "fcs_equals_structured_long_cs", "fcs_cp_equals_general",
    "ts_cp_equals_general", "hcs_cp_equals_general",
    "tiuu_z_trick_equals_direct"])
def test_structured_identities_hold_in_the_port(name):
    got, want, tol = _identity(name)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    # the reference's own helper gives the same long pair
    if name == "fcs_equals_structured_long_cs":
        ref_h, port_h = _hashes(DIMS, 16, 3)
        for a, b in zip(combined_fcs_hash(port_h), ref_combined(ref_h)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
