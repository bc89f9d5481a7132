"""Port parity: CP decomposition in ``repro_torch`` (cpd/rtpm.py oracles
and RTPM, cpd/als.py) against the JAX package's ``repro.cpd`` on tensors
made by numpy from a seed, with the reference's hashes carried across by
``bridge.mode_hashes_from_reference`` and the reference's ``jax.random``
inits recomputed here and handed to the port (the port draws its own from
a ``torch.Generator`` otherwise).  CPU tensors throughout, so every CS
apply and lookup takes the kernels' plain versions; ``launch/cpd.py``
runs on the CPU.

Tolerances.  Oracle contractions go through FFTs and f32 sums in another
order: within 1e-4 x max|value|.  RTPM on a clean tensor with
well-separated weights: lambdas within 1e-4 relative, factors within 1e-3
up to sign.  One ALS sweep from the same factors: within 1e-4 (factors
and lambdas, relative to max|value|).  Inside the port, a batch of vectors
gives each row's single-vector result within 1e-5 x max|value|, and ALS
on a clean tensor reaches residual < 1e-2."""
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as rc
from repro.cpd import als as ref_als
from repro.cpd import rtpm as ref_rtpm
from repro_torch.cpd import als, rtpm
from repro_torch.launch import cpd as launch_cpd
from repro_torch.models.bridge import mode_hashes_from_reference

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _sym_tensor(I, R, lams, noise=0.0, seed=0):
    rng = np.random.RandomState(seed)
    U = np.linalg.qr(rng.randn(I, I))[0][:, :R]
    T = np.einsum("r,ar,br,cr->abc", lams, U, U, U)
    if noise:
        T = T + noise * rng.randn(I, I, I)
    return T.astype(np.float32), U.astype(np.float32)


def _oracles(method, T, seed=3):
    """The reference's and the port's oracle over T with the same hashes."""
    I = T.shape[0]
    key = jax.random.PRNGKey(seed)
    if method == "plain":
        return (ref_rtpm.plain_oracle(jnp.asarray(T)),
                rtpm.plain_oracle(_t(T)))
    if method == "cs":
        ref_h = rc.make_mode_hash(key, I ** 3, 500, 3)
    else:
        ref_h = rc.make_tensor_hashes(key, T.shape,
                                      6 if method == "hcs" else 100, 3)
    port_h = mode_hashes_from_reference(ref_h, "cpu")
    return (ref_rtpm.ORACLES[method](jnp.asarray(T), ref_h),
            rtpm.ORACLES[method](_t(T), port_h))


@pytest.mark.parametrize("method", ["plain", "fcs", "ts", "cs", "hcs"])
def test_oracles_match_reference(method):
    T, _ = _sym_tensor(10, 3, np.array([3.0, 2.0, 1.0]), noise=0.01, seed=1)
    (r_tiuu, r_tuuu), (p_tiuu, p_tuuu) = _oracles(method, T)
    U = np.random.RandomState(2).randn(3, 10).astype(np.float32)
    U /= np.linalg.norm(U, axis=1, keepdims=True)
    for u in U:
        _close(p_tiuu(_t(u)), r_tiuu(jnp.asarray(u)), 1e-4)
        _close(p_tuuu(_t(u)), r_tuuu(jnp.asarray(u)), 1e-4)
    # rtpm's batch of inits: each row the single-vector contraction
    _close(p_tiuu(_t(U)), torch.stack([p_tiuu(_t(u)) for u in U]), 1e-5)
    _close(p_tuuu(_t(U)), torch.stack([p_tuuu(_t(u)) for u in U]), 1e-5)


@pytest.mark.parametrize("method", ["fcs", "ts"])
def test_oracles_match_reference_at_fig1_size(method):
    """The paper's Fig. 1 widths (I = 100, rank 10, sigma 0.01, J = 10000,
    D = 2; FCS sketch length 29,998), where a fault in the FFT length, the
    index width or the hash range would show and the reduced sizes above
    would not.  Two unit vectors, within 1e-4 x max|value|."""
    I, R, J, D = 100, 10, 10000, 2
    T, _ = _sym_tensor(I, R, np.ones(R), noise=0.01, seed=6)
    ref_h = rc.make_tensor_hashes(jax.random.PRNGKey(7), T.shape, J, D)
    r_tiuu, r_tuuu = ref_rtpm.ORACLES[method](jnp.asarray(T), ref_h)
    p_tiuu, p_tuuu = rtpm.ORACLES[method](
        _t(T), mode_hashes_from_reference(ref_h, "cpu"))
    U = np.random.RandomState(8).randn(2, I).astype(np.float32)
    U /= np.linalg.norm(U, axis=1, keepdims=True)
    for u in U:
        _close(p_tiuu(_t(u)), r_tiuu(jnp.asarray(u)), 1e-4)
        _close(p_tuuu(_t(u)), r_tuuu(jnp.asarray(u)), 1e-4)


def _ref_inits(key, rank, L, I):
    """The raw inits the reference's ``rtpm`` draws for each component."""
    raw = []
    for _ in range(rank):
        key, k1 = jax.random.split(key)
        raw.append(np.asarray(jax.random.normal(k1, (L, I))))
    return torch.from_numpy(np.stack(raw))


@pytest.mark.parametrize("method", ["plain", "fcs"])
def test_rtpm_matches_reference_on_a_clean_tensor(method):
    """I = 25, rank 3, weights 3, 2, 1 (tests/test_cpd.py:24).  The
    weights are 1 apart, 1e4 times the lambda tolerance, so the argmax over
    candidates cannot flip between two components on rounding: the
    recovered lambdas are asserted to keep that margin."""
    I, R, L, iters, J, D = 25, 3, 8, 15, 1000, 3
    lams = np.array([3.0, 2.0, 1.0])
    T, U = _sym_tensor(I, R, lams)
    want_l, want_U = ref_rtpm.rtpm_decompose(
        jnp.asarray(T), R, KEY, method=method, hash_len=J, n_sketches=D,
        n_inits=L, n_iters=iters)
    hashes = None
    if method != "plain":
        hashes = mode_hashes_from_reference(
            rc.make_tensor_hashes(KEY, T.shape, [J] * 3, D), "cpu")
    got_l, got_U = rtpm.rtpm_decompose(
        _t(T), R, method=method, n_inits=L, n_iters=iters, hashes=hashes,
        inits=_ref_inits(KEY, R, L, I))
    want_l, want_U = np.asarray(want_l), np.asarray(want_U)
    assert np.all(np.diff(want_l) < -0.5), want_l       # margin: no near tie
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=1e-4)
    sign = np.sign(np.sum(got_U.numpy() * want_U, axis=0))
    np.testing.assert_allclose(got_U.numpy() * sign, want_U, rtol=0,
                               atol=1e-3)
    if method == "plain":
        assert float(rtpm.residual_norm(_t(T), got_l, got_U)) < 1e-3


def _ref_als_inits(T, rank, key, n_inits):
    """The inits the reference's ``als_decompose`` builds (HOSVD plus
    noise, then random), recomputed with JAX: HOSVD signs from two LAPACK
    builds need not agree, so the port is handed these."""
    kA, kB, kC, kh = jax.random.split(key, 4)

    def hosvd(mode, k, dim):
        M = jnp.moveaxis(T, mode, 0).reshape(dim, -1)
        u = jnp.linalg.svd(M, full_matrices=False)[0][:, :rank]
        return u + 0.01 * jax.random.normal(k, (dim, rank))

    I1, I2, I3 = T.shape
    inits = [(hosvd(0, kA, I1), hosvd(1, kB, I2), hosvd(2, kC, I3))]
    for j in range(n_inits - 1):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, j + 1), 3)
        inits.append((jax.random.normal(k1, (I1, rank)),
                      jax.random.normal(k2, (I2, rank)),
                      jax.random.normal(k3, (I3, rank))))
    port = [tuple(_t(np.asarray(f)) for f in init) for init in inits]
    return port, kh


@pytest.mark.parametrize("method,n_iters,n_inits", [
    ("plain", 1, 1), ("fcs", 1, 1), ("ts", 1, 1), ("fcs", 4, 2)])
def test_als_matches_reference_from_the_same_factors(method, n_iters,
                                                     n_inits):
    """n_iters = 1 with one init is exactly one sweep from the HOSVD
    factors; (4, 2) adds the probe and the pick between two inits."""
    rng = np.random.RandomState(4)
    F = [np.linalg.qr(rng.randn(14, 14))[0][:, :3] for _ in range(3)]
    T = (np.einsum("ar,br,cr->abc", *F)
         + 0.01 * rng.randn(14, 14, 14)).astype(np.float32)
    J, D = 300, 3
    want_l, want_F = ref_als.als_decompose(
        jnp.asarray(T), 3, KEY, method=method, hash_len=J, n_sketches=D,
        n_iters=n_iters, n_inits=n_inits)
    inits, kh = _ref_als_inits(jnp.asarray(T), 3, KEY, n_inits)
    hashes = None
    if method != "plain":
        hashes = mode_hashes_from_reference(
            rc.make_tensor_hashes(kh, T.shape, J, D), "cpu")
    got_l, got_F = als.als_decompose(_t(T), 3, method=method,
                                     n_iters=n_iters, inits=inits,
                                     hashes=hashes)
    _close(got_l, want_l, 1e-4)
    for g, w in zip(got_F, want_F):
        _close(g, w, 1e-4)


def test_als_recovers_a_clean_tensor():
    """Inside the port, its own inits from a generator (tests/test_cpd.py::
    test_als_exact_on_clean_tensor)."""
    rng = np.random.RandomState(5)
    F = [np.linalg.qr(rng.randn(20, 20))[0][:, :4] for _ in range(3)]
    T = _t(np.einsum("ar,br,cr->abc", *F).astype(np.float32))
    lam, fac = als.als_decompose(T, 4, torch.Generator().manual_seed(0),
                                 method="plain", n_iters=25)
    assert float(als.als_residual(T, lam, fac)) < 1e-2


def test_launch_cpd_runs_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        launch_cpd.main(["--device", "cpu", "--methods", "plain,fcs"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("symmetric CP rank-8 tensor, 50^3")
    rows = [ln.split() for ln in lines if ln.startswith("  ")]
    assert [r[0] for r in rows] == ["plain", "fcs"]
    clean = {r[0]: float(ln.split("(observed), ")[1].split()[0])
             for r, ln in zip(rows, [ln for ln in lines
                                     if ln.startswith("  ")])}
    assert clean["plain"] < 0.3 and 0 < clean["fcs"] < 1.5
