"""Port parity: the sketch hash family and the count-min container of
``repro_torch`` against the JAX package.  Integer results, so the
tolerance is zero: buckets, signs, tables and estimates are bitwise."""
import numpy as np
import pytest
import torch

from repro.serve import prefix_cache as ref_pc
from repro.sketch import csvec as ref_csvec
from repro.sketch import hashing as ref_hashing
from repro_torch.serve import prefix_cache as pc
from repro_torch.sketch import csvec, hashing

# tiny tensors: one intra-op thread keeps the pytest-xdist workers from
# oversubscribing the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 7, 12345, 2 ** 31 - 1])
def test_make_coeffs_identical(seed):
    np.testing.assert_array_equal(np.asarray(ref_hashing.make_coeffs(seed, 5)),
                                  hashing.make_coeffs(seed, 5))


@pytest.mark.parametrize("seed,cols,signed", [
    (0, 1024, False), (3, 1024, True), (99, 7, True), (2 ** 20, 4096, False),
    (2 ** 31 - 1, 1, True)])
def test_buckets_signs_bitwise(seed, cols, signed):
    """Random indices over the whole uint32-safe int32 range, including
    the extremes, hash to the reference's buckets and signs."""
    rng = np.random.RandomState(seed % 1000)
    idx = np.concatenate([rng.randint(0, 2 ** 31 - 1, 2000),
                          [0, 1, 2 ** 31 - 1]]).astype(np.int32)
    rb, rs = ref_hashing.row_buckets_signs(
        ref_hashing.cached_coeffs(seed, 4), idx, cols, signed)
    tb, ts = hashing.row_buckets_signs(hashing.cached_coeffs(seed, 4),
                                       torch.as_tensor(idx), cols, signed)
    np.testing.assert_array_equal(np.asarray(rb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(rs), ts.numpy())


@pytest.mark.parametrize("seed", [0, 11])
def test_count_min_tables_and_query_bitwise(seed):
    """Count-min accumulate / query / decay on integer counts: the tables
    and the min-of-rows estimates equal the reference's bit for bit."""
    rng = np.random.RandomState(seed)
    ref = ref_csvec.csvec_zeros(1 << 20, cols=256, rows=4, seed=seed,
                                signed=False)
    port = csvec.csvec_zeros(1 << 20, cols=256, rows=4, seed=seed,
                             signed=False)
    for step in range(5):
        idx = rng.randint(0, 1 << 20, 300).astype(np.int32)
        vals = rng.randint(1, 4, 300).astype(np.float32)
        ref = ref_csvec.accumulate_coords(ref, idx, vals)
        csvec.accumulate_coords(port, torch.as_tensor(idx),
                                torch.as_tensor(vals))
        if step == 3:
            ref = ref_csvec.decay(ref, 0.5)
            csvec.decay(port, 0.5)
        np.testing.assert_array_equal(np.asarray(ref.table),
                                      port.table.numpy())
        q = rng.randint(0, 1 << 20, 500).astype(np.int32)
        np.testing.assert_array_equal(np.asarray(ref_csvec.query(ref, q)),
                                      csvec.query(port,
                                                  torch.as_tensor(q)).numpy())
    assert csvec.state_bytes(port) == ref_csvec.state_bytes(ref)


def test_signed_csvec_not_ported():
    """The signed (median) container was the part left out of the first
    slice; it is ported now.  Integer values, so its table and median
    estimates equal the reference's bit for bit (the median of an even
    row count averages two integers, exact in f32)."""
    rng = np.random.RandomState(5)
    idx = rng.randint(0, 1 << 20, 400).astype(np.int32)
    vals = rng.randint(-3, 4, 400).astype(np.float32)
    for rows in (3, 4):
        ref = ref_csvec.accumulate_coords(
            ref_csvec.csvec_zeros(1 << 20, cols=64, rows=rows, seed=9,
                                  signed=True), idx, vals)
        port = csvec.accumulate_coords(
            csvec.csvec_zeros(1 << 20, cols=64, rows=rows, seed=9,
                              signed=True), torch.as_tensor(idx),
            torch.as_tensor(vals))
        np.testing.assert_array_equal(np.asarray(ref.table),
                                      port.table.numpy())
        np.testing.assert_array_equal(
            np.asarray(ref_csvec.query(ref, idx)),
            csvec.query(port, torch.as_tensor(idx)).numpy())
        np.testing.assert_array_equal(np.asarray(ref_csvec.query_all(ref)),
                                      csvec.query_all(port).numpy())


def test_prefix_key_identical():
    rng = np.random.RandomState(1)
    for n in (1, 16, 97):
        toks = rng.randint(0, 50000, n).astype(np.int32)
        assert pc.prefix_key(toks) == ref_pc.prefix_key(toks)
