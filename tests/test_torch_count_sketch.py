"""Port parity: the count-sketch and unsketch ops of ``repro_torch``
(kernels/ref.py plain versions, kernels/ops.py dispatch on CPU tensors)
against the JAX package's Pallas ``count_sketch`` / ``unsketch`` in
interpret mode and against its oracles, on inputs made by numpy from a
seed and handed to both.

Tolerances.  The count sketch sums the same f32 terms in another order
(the reference contracts a signed one-hot, the port index-adds): rtol =
atol = 2e-5, as tests/test_kernels.py holds the Pallas kernel to its
oracle; 3e-2 for bf16 input against the f32 oracle.  The decompress is a
gather times +-1, exact in both: bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.count_sketch import count_sketch as ref_count_sketch
from repro.kernels.unsketch import unsketch as ref_unsketch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.count_sketch import (count_sketch, inverse_index,
                                              unsketch)

torch.set_num_threads(1)

# tests/test_kernels.py's shapes (B, I, J) and block settings
SHAPES = [(1, 64, 32), (4, 1000, 256), (2, 300, 64), (8, 4096, 512),
          (1, 50, 300), (3, 128, 128)]
BLOCKS = [(2, 128, 128), (4, 256, 64)]


def _inputs(B, I, J, seed=0, D=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, I).astype(np.float32)
    shape = (I,) if D is None else (D, I)
    h = rng.randint(0, J, shape).astype(np.int32)
    s = (1.0 - 2.0 * rng.randint(0, 2, shape)).astype(np.float32)
    return x, h, s


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("blocks", BLOCKS)
def test_count_sketch_matches_reference(shape, blocks):
    B, I, J = shape
    bB, bI, bJ = blocks
    x, h, s = _inputs(B, I, J)
    want_kernel = np.asarray(ref_count_sketch(jnp.asarray(x), jnp.asarray(h),
                                              jnp.asarray(s), J, bB=bB,
                                              bI=bI, bJ=bJ))
    want_oracle = np.asarray(rref.count_sketch_ref(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(s), J))
    xt, ht, st = _t(x, h, s)
    for got in (ref.count_sketch_ref(xt, ht, st, J),
                ops.count_sketch_op(xt, ht, st, J)):
        assert got.shape == (B, J) and got.dtype == torch.float32
        for want in (want_kernel, want_oracle):
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                       atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_unsketch_matches_reference_bitwise(shape):
    B, I, J = shape
    _, h, s = _inputs(B, I, J)
    y = np.random.RandomState(9).randn(B, J).astype(np.float32)
    want_kernel = np.asarray(ref_unsketch(jnp.asarray(y), jnp.asarray(h),
                                          jnp.asarray(s), bB=2, bI=128,
                                          bJ=128))
    want_oracle = np.asarray(rref.unsketch_ref(jnp.asarray(y), jnp.asarray(h),
                                               jnp.asarray(s)))
    yt, ht, st = _t(y, h, s)
    for got in (ref.unsketch_ref(yt, ht, st), ops.unsketch_op(yt, ht, st)):
        assert got.shape == (B, I) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want_kernel)
        np.testing.assert_array_equal(got.numpy(), want_oracle)


def test_count_sketch_bf16_input():
    """bf16 x accumulates in f32 and returns bf16, within 3e-2 of the f32
    oracle (as tests/test_kernels.py::test_count_sketch_dtypes)."""
    x, h, s = _inputs(4, 512, 128)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.count_sketch_op(xb, *_t(h, s), 128)
    assert got.dtype == torch.bfloat16
    want = np.asarray(rref.count_sketch_ref(
        jnp.asarray(xb.float().numpy()), jnp.asarray(h), jnp.asarray(s),
        128))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


def test_roundtrip_unbiased_entries():
    """unsketch(count_sketch(x)) has the right diagonal: each entry holds
    its own value plus zero-mean collision noise (as
    tests/test_kernels.py::test_roundtrip_unbiased_entries)."""
    x, h, s = _t(*_inputs(1, 256, 4096, seed=3))
    y = ops.count_sketch_op(x, h, s, 4096)
    err = (ops.unsketch_op(y, h, s) - x).abs()
    # J >> I: expected collision-free fraction ~ (1 - 1/J)^(I-1) ~ 94%
    assert float((err < 1e-4).float().mean()) > 0.85
    assert float(err.median()) < 1e-5


@pytest.mark.parametrize("D", [2, 3])
def test_stacked_rows_equal_separate_calls(D):
    """D stacked hash rows in one call equal D one-row calls, for a shared
    and a per-row y (bitwise: each output is the same sum)."""
    x, h, s = _t(*_inputs(3, 700, 96, seed=4, D=D))
    stacked = ops.count_sketch_op(x, h, s, 96)
    assert stacked.shape == (D, 3, 96)
    for d in range(D):
        torch.testing.assert_close(stacked[d],
                                   ops.count_sketch_op(x, h[d], s[d], 96),
                                   rtol=0, atol=0)
    y = stacked.contiguous()
    for yy in (y, y[0]):
        out = ops.unsketch_op(yy, h, s)
        assert out.shape == (D, 3, 700)
        for d in range(D):
            torch.testing.assert_close(
                out[d], ops.unsketch_op(yy[d] if yy.ndim == 3 else yy,
                                        h[d], s[d]), rtol=0, atol=0)


def test_inverse_index_lists_each_bucket_in_order():
    """perm / offsets list bucket j's members in increasing i; an entry
    outside [0, J) lies in no bucket."""
    _, h, _ = _inputs(1, 500, 40, seed=5, D=2)
    h[1, 7] = 40                                 # out of range
    perm, offsets = inverse_index(torch.from_numpy(h), 40)
    assert perm.dtype == offsets.dtype == torch.int32
    assert perm.shape == (2, 500) and offsets.shape == (2, 41)
    for d in range(2):
        for j in range(40):
            members = perm[d, offsets[d, j]:offsets[d, j + 1]].numpy()
            np.testing.assert_array_equal(members, np.flatnonzero(h[d] == j))
    assert int(offsets[1, -1]) == 499


def test_kernel_path_refuses_cpu_tensors():
    """use_kernel=True on CPU tensors raises (a CUDA kernel has no CPU or
    interpret mode), and so do the kernel wrappers themselves."""
    x, h, s = _t(*_inputs(2, 64, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.count_sketch_op(x, h, s, 16, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.unsketch_op(x[:, :16].contiguous(), h, s, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        count_sketch(x, h, s, 16)
    with pytest.raises(ValueError, match="CUDA"):
        unsketch(x[:, :16].contiguous(), h, s)
    # use_kernel=False is the plain version on either device
    torch.testing.assert_close(ops.count_sketch_op(x, h, s, 16,
                                                   use_kernel=False),
                               ref.count_sketch_ref(x, h, s, 16))
