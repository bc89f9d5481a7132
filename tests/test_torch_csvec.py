"""Port parity: the count-sketch container's query, heavy-hitter, norm and
algebra functions (``query_row``, ``topk``, ``l2_estimate``, ``merge``,
``scale``) against the JAX package's ``repro/sketch/csvec.py``, on tables
both packages built from the same coordinates and values.

Tolerances.  Integer values keep every table cell, row estimate and
median exact in f32, so those are held bitwise; ``l2_estimate`` takes a
square root of an exact integer (f32 rounding, 1e-6 relative).  ``topk``
is held as index sets and values: ``jax.lax.top_k`` and ``torch.topk``
may order equal magnitudes differently."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sketch import csvec as ref_csvec
from repro_torch.sketch import csvec

torch.set_num_threads(1)

D = 1 << 16


def _both(seed, rows, cols, signed, n=600):
    """The same integer stream accumulated into a reference container and
    a port container."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, D, n).astype(np.int32)
    lo = -5 if signed else 1
    vals = rng.randint(lo, 6, n).astype(np.float32)
    ref = ref_csvec.accumulate_coords(
        ref_csvec.csvec_zeros(D, cols=cols, rows=rows, seed=seed,
                              signed=signed), idx, vals)
    port = csvec.accumulate_coords(
        csvec.csvec_zeros(D, cols=cols, rows=rows, seed=seed, signed=signed),
        torch.as_tensor(idx), torch.as_tensor(vals))
    np.testing.assert_array_equal(np.asarray(ref.table), port.table.numpy())
    return ref, port, idx


CASES = [(3, 3, 64, True), (4, 4, 128, True), (5, 3, 256, False),
         (6, 5, 32, False)]


@pytest.mark.parametrize("seed,rows,cols,signed", CASES)
def test_query_row_equals_reference(seed, rows, cols, signed):
    ref, port, idx = _both(seed, rows, cols, signed)
    q = np.concatenate([idx[:50], np.arange(40, dtype=np.int32)])
    for r in range(rows):
        np.testing.assert_array_equal(
            np.asarray(ref_csvec.query_row(ref, jnp.asarray(q), r)),
            csvec.query_row(port, torch.as_tensor(q), r).numpy())


@pytest.mark.parametrize("seed,rows,cols,signed", CASES)
def test_topk_equals_reference(seed, rows, cols, signed):
    """The k heaviest estimates: the same index set with the same values
    (each index's estimate equal), order aside."""
    ref, port, _ = _both(seed, rows, cols, signed)
    # k inside a run of equal magnitudes would let the sets differ:
    # take k where the magnitude strictly drops
    mags = np.sort(np.abs(np.asarray(ref_csvec.query_all(ref))))[::-1]
    k = next(i for i in range(20, len(mags)) if mags[i] < mags[i - 1])
    rix, rv = (np.asarray(a) for a in ref_csvec.topk(ref, k))
    tix, tv = csvec.topk(port, k)
    assert sorted(rix.tolist()) == sorted(tix.tolist())
    want = dict(zip(rix.tolist(), rv.tolist()))
    assert all(want[i] == v for i, v in zip(tix.tolist(), tv.tolist()))
    assert (np.abs(tv.numpy()) >= mags[k - 1]).all()


@pytest.mark.parametrize("seed,rows,cols,signed", CASES)
def test_l2_estimate_equals_reference(seed, rows, cols, signed):
    ref, port, _ = _both(seed, rows, cols, signed)
    want = float(ref_csvec.l2_estimate(ref))
    got = float(csvec.l2_estimate(port))
    assert abs(got - want) <= 1e-6 * want, (got, want)


@pytest.mark.parametrize("signed", [True, False])
def test_merge_and_scale_equal_reference(signed):
    """merge is the sketch of the sum (a new container; the operands are
    left as they were), scale the sketch of the scaled vector (in place
    in the port); a mismatched pair raises as in the reference."""
    ra, pa, _ = _both(11, 3, 64, signed)
    rb, pb, _ = _both(11, 3, 64, signed, n=300)
    a0 = pa.table.clone()
    rm = ref_csvec.merge(ra, rb)
    pm = csvec.merge(pa, pb)
    np.testing.assert_array_equal(np.asarray(rm.table), pm.table.numpy())
    assert pm is not pa and torch.equal(pa.table, a0)
    assert (pm.d, pm.signed, pm.seed) == (rm.d, rm.signed, rm.seed)
    rs = ref_csvec.scale(rm, 0.25)
    ps = csvec.scale(pm, 0.25)
    assert ps is pm
    np.testing.assert_array_equal(np.asarray(rs.table), ps.table.numpy())
    q = torch.arange(300)
    np.testing.assert_array_equal(
        np.asarray(ref_csvec.query(rs, jnp.arange(300, dtype=jnp.int32))),
        csvec.query(ps, q).numpy())
    for other in (csvec.csvec_zeros(D, cols=64, rows=3, seed=12,
                                    signed=signed),
                  csvec.csvec_zeros(D, cols=32, rows=3, seed=11,
                                    signed=signed),
                  csvec.csvec_zeros(D, cols=64, rows=3, seed=11,
                                    signed=not signed),
                  csvec.csvec_zeros(D + 1, cols=64, rows=3, seed=11,
                                    signed=signed)):
        with pytest.raises(ValueError, match="CSVec mismatch"):
            csvec.merge(pa, other)
    with pytest.raises(ValueError, match="CSVec mismatch"):
        ref_csvec.merge(ra, ref_csvec.csvec_zeros(D, cols=64, rows=3,
                                                  seed=12, signed=signed))
