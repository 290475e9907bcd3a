"""Shared test helpers: dtype-aware tolerances and dense comparison."""

import numpy as np


def tols(*dtypes):
    """Comparison tolerances by value dtype (reference uses rel=1e-5,
    abs=1e-10 for f8, tests/test_multiply.py:44; f4 needs wider bounds
    because device accumulation differs in order and precision)."""
    if any(np.dtype(d) == np.float32 for d in dtypes):
        return dict(rtol=5e-4, atol=5e-3)
    return dict(rtol=1e-5, atol=1e-10)


def dense_tols(ref, *dtypes):
    """Scale-aware tolerances for products of bounded (±1e3) values."""
    t = tols(*dtypes)
    scale = float(np.max(np.abs(ref))) if np.asarray(ref).size else 1.0
    return dict(rtol=t["rtol"], atol=t["atol"] * max(1.0, scale))


def to_dense(csr):
    return csr.to_scipy().toarray()


def assert_spmv_close(y, ref, csr, x):
    """SpMV comparison under the accumulation-aware bound of
    :mod:`csr_tpu.utils.tolerance`: per row, ``rtol * |ref|`` plus a
    multiple of eps times the row's own L1 mass ``|A| @ |x|``.  A fixed
    atol fails on catastrophic cancellation: a row of terms of magnitude
    ~1e4 summing to ~1 carries an f32 error of ~1e4 * eps however it is
    computed."""
    from csr_tpu.utils import tolerance

    row_l1 = np.abs(to_dense(csr)).astype(np.float64) @ np.abs(
        np.asarray(x, np.float64)
    )
    tolerance.check(y, ref, row_l1, np.float32, "SpMV")


def assert_csr_close(actual, expect_dense, **kw):
    a = to_dense(actual)
    np.testing.assert_allclose(a, expect_dense, **kw)
