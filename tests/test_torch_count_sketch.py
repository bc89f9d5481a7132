"""Port parity: the count-sketch and unsketch ops of ``repro_torch``
(kernels/ref.py plain versions, kernels/ops.py dispatch on CPU tensors)
against the JAX package's Pallas ``count_sketch`` / ``unsketch`` in
interpret mode and against its oracles, on inputs made by numpy from a
seed and handed to both.

Tolerances.  The count sketch sums the same f32 terms in another order
(the reference contracts a signed one-hot, the port index-adds): rtol =
atol = 2e-5, as tests/test_kernels.py holds the Pallas kernel to its
oracle; 3e-2 for bf16 input against the f32 oracle.  The decompress is a
gather times +-1, exact in both: bitwise.

The CUDA count sketch adds in the order of its bucket links and its plan
(chunks of I, tiles, each bucket's chain of a tile); ``ref.
count_sketch_tiled_ref`` is the plain model of that order, held here to
the reference at the same tolerance, and the links and the plan are
checked against brute-force listings."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.count_sketch import count_sketch as ref_count_sketch
from repro.kernels.unsketch import unsketch as ref_unsketch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.count_sketch import (MAX_SMEM_BYTES, SMS, TILE,
                                              bucket_links, count_sketch,
                                              plan, smem_bytes, unsketch)

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


# (I, J): ragged I over three tiles, J = 1 (every entry one bucket), one
# tile with J > I, and a ragged I past one tile
LINK_CASES = [(5000, 37), (5000, 1), (100, 10_000), (4097, 3000)]


@pytest.mark.parametrize("I,J", LINK_CASES)
def test_bucket_links_chain_each_bucket_of_a_tile_in_order(I, J):
    """Each entry links to the next entry of its tile in its bucket (bits
    0-10, valid with bit 11), bit 12 marks an earlier one and bit 15 the
    sign; entries with h >= J or h < 0 are in no chain."""
    _, h, s = _inputs(1, I, J, seed=5, D=2)
    h[1, 7], h[0, 3], h[0, I - 1] = J, J + 5, -2          # out of range
    lk = bucket_links(torch.from_numpy(h), torch.from_numpy(s), J)
    assert lk.dtype == torch.int16 and lk.shape == (2, I)
    lk = lk.numpy().astype(np.int64) & 0xffff
    for d in range(2):
        for i in range(I):
            t0 = i // TILE * TILE
            t1 = min(I, t0 + TILE)
            ok = 0 <= h[d, i] < J
            later = np.flatnonzero(h[d, i + 1:t1] == h[d, i]) if ok else []
            assert bool(lk[d, i] & 0x800) == (len(later) > 0), (d, i)
            if len(later):
                assert lk[d, i] & 0x7ff == i + 1 + later[0] - t0, (d, i)
            prev = ok and bool(np.any(h[d, t0:i] == h[d, i]))
            assert bool(lk[d, i] & 0x1000) == prev, (d, i)
            assert (lk[d, i] >> 15) == (s[d, i] < 0), (d, i)
    # a 1-D table gives the same links as its row
    one = bucket_links(torch.from_numpy(h[0]), torch.from_numpy(s[0]), J)
    assert one.shape == (1, I) and np.array_equal(
        one.numpy().astype(np.int64)[0] & 0xffff, lk[0])


# (D, B, I, J): one chunk, several tiles in several chunks, J > I, and one
# repetition per block with rows past B
TILED_CASES = [(1, 4, 1000, 256), (2, 3, 9000, 40), (2, 2, 300, 5000),
               (3, 5, 20_000, 128)]


@pytest.mark.parametrize("shape", TILED_CASES)
def test_tiled_model_matches_reference(shape):
    """The kernel's order of additions (chunks, tiles, rank rounds) sums
    the same as the reference's Pallas kernel and oracle, per repetition;
    out-of-range entries contribute nothing."""
    D, B, I, J = shape
    x, h, s = _inputs(B, I, J, seed=6, D=D)
    h[0, 5] = J + 3
    xt, ht, st = _t(x, h, s)
    got = ref.count_sketch_tiled_ref(xt, ht, st, J)
    assert got.shape == (D, B, J)
    dropped = x.copy()
    dropped[:, 5] = 0.0                           # row 0's entry 5
    for d in range(D):
        xd = jnp.asarray(dropped if d == 0 else x)
        hd, sd = jnp.asarray(h[d]), jnp.asarray(s[d])
        for want in (rref.count_sketch_ref(xd, hd, sd, J),
                     ref_count_sketch(xd, hd, sd, J, bB=2, bI=128, bJ=128)):
            np.testing.assert_allclose(got[d].numpy(), np.asarray(want),
                                       rtol=2e-5, atol=2e-5)
    # a repetition alone sums in the same order as stacked
    assert torch.equal(got[D - 1], ref.count_sketch_tiled_ref(
        xt, ht[D - 1], st[D - 1], J))


# (D, B, I, J, x bytes): the cpd path's CS oracle (B 100 and vec(T) at
# B 1), the FCS tiuu, a J past the shared-memory accumulators, bf16, the
# reference's shapes
PLAN_CASES = [(2, 100, 1_000_000, 10_000, 4), (2, 1, 1_000_000, 10_000, 4),
              (2, 15, 100, 10_000, 4), (2, 8, 300_000, 200_000, 4),
              (1, 4, 512, 128, 2), (1, 8, 4096, 512, 4), (3, 5, 2000, 300, 4),
              (20, 1, 2_400_000, 1_199_997, 4)]


@pytest.mark.parametrize("shape", PLAN_CASES)
def test_plan_fits_and_covers(shape):
    """Every block fits in shared memory, the slabs cover J and the chunks
    cover the tiles; the chunks, which set the order of additions, are
    the same for any D."""
    D, B, I, J, esize = shape
    pl = plan(D, B, I, J, esize)
    assert smem_bytes(pl.reps, pl.rows, pl.slab, esize) <= MAX_SMEM_BYTES
    assert pl.rows in (1, 2, 4) and D % pl.reps == 0
    assert (pl.slabs - 1) * pl.slab < J <= pl.slabs * pl.slab
    tiles = max(1, -(-I // TILE))
    assert (pl.chunks - 1) * pl.tiles_per_chunk < tiles
    assert tiles <= pl.chunks * pl.tiles_per_chunk
    assert pl.blocks == (-(-B // pl.rows) * pl.chunks * pl.slabs
                         * (D // pl.reps))
    for D2 in (1, 2, 3):
        other = plan(D2, B, I, J, esize)
        assert (other.chunks, other.tiles_per_chunk) == (
            pl.chunks, pl.tiles_per_chunk)
    if smem_bytes(1, 1, J, esize) > MAX_SMEM_BYTES:
        assert pl.slabs > 1                              # J-slab branch
    if B >= 15:
        assert pl.blocks >= SMS // 2                     # fills the card


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
