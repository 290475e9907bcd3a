"""The ``xla`` kernel against scipy at the edge shapes of the device path.

Every contract op (``mult_vec``, ``mult_vec_t``, ``mult_dense``,
``multiply`` and ``multiply(transpose=True)``) runs on each shape and is
compared with scipy in float64 under the bounds of
:mod:`csr_tpu.utils.tolerance`: a 1x1 matrix, an empty one, an operand of
3,000,000 columns, an output of 3,000,000 rows, one hub row holding half
the entries, interleaved empty rows, a structure-only matrix and a plain
512x640 one.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.sparse as sps

from csr_tpu import CSR
from csr_tpu.kernels import use_kernel
from csr_tpu.utils import tolerance


def _row_nnz(shape, rng):
    """(nrows, ncols, entries per row, has values) of each test shape."""
    if shape == "1x1":
        return 1, 1, np.ones(1, np.int64), True
    if shape == "nnz0":
        return 5, 7, np.zeros(5, np.int64), True
    if shape == "wide_3m":
        return 64, 3_000_000, np.full(64, 32, np.int64), True
    if shape == "tall_3m":
        counts = np.zeros(3_000_000, np.int64)
        counts[rng.choice(3_000_000, 2048, replace=False)] = 1
        return 3_000_000, 64, counts, True
    if shape == "hub_row":
        counts = np.full(200, 3, np.int64)
        counts[17] = 600  # half the entries in one row
        return 200, 150, counts, True
    if shape == "empty_rows":
        counts = np.zeros(300, np.int64)
        counts[::2] = 6
        return 300, 200, counts, True
    if shape == "structure_only":
        return 120, 90, np.full(120, 5, np.int64), False
    if shape == "512x640":
        return 512, 640, np.full(512, 19, np.int64), True
    raise ValueError(shape)


SHAPES = ["1x1", "nnz0", "wide_3m", "tall_3m", "hub_row", "empty_rows",
          "structure_only", "512x640"]
OPS = ["mult_vec", "mult_vec_t", "mult_dense", "multiply", "multiply_t"]


def _random(rng, nrows, ncols, counts, has_values, dtype):
    """A device CSR and the same matrix as a float64 scipy matrix (built
    from copies: scipy sums duplicates in place)."""
    rowptr = np.zeros(nrows + 1, np.int64)
    np.cumsum(counts, out=rowptr[1:])
    nnz = int(rowptr[-1])
    cols = rng.integers(0, max(ncols, 1), nnz, dtype=np.int32)
    vals = rng.standard_normal(nnz).astype(dtype) if has_values else None
    ref_vals = np.ones(nnz) if vals is None else vals.astype(np.float64)
    ref = sps.csr_matrix((ref_vals, cols.copy(), rowptr.copy()),
                         shape=(nrows, ncols))
    return CSR(nrows, ncols, nnz, rowptr, cols, vals), ref


def _sparse_operand(rng, nrows, ncols, dtype):
    """A sparse right-hand side with about 20 entries per 1,000 cells
    along its longer side."""
    counts = rng.binomial(max(ncols // 50, 1), 0.5, nrows).astype(np.int64)
    return _random(rng, nrows, ncols, counts, True, dtype)


def _check(op, shape, dtype):
    rng = np.random.default_rng(SHAPES.index(shape))
    nrows, ncols, counts, has_values = _row_nnz(shape, rng)
    a, ref = _random(rng, nrows, ncols, counts, has_values, dtype)
    abs_a = abs(ref)
    if op in ("mult_vec", "mult_vec_t", "mult_dense"):
        n_in = nrows if op == "mult_vec_t" else ncols
        x = rng.standard_normal((n_in, 3) if op == "mult_dense" else n_in)
        x = x.astype(dtype)
        x64 = x.astype(np.float64)
        m, am = (ref.T, abs_a.T) if op == "mult_vec_t" else (ref, abs_a)
        out = getattr(a, op)(jnp.asarray(x))
        assert out.dtype == jnp.dtype(dtype)
        tolerance.check(out, m @ x64, am @ np.abs(x64), dtype, op)
        return
    if op == "multiply":
        b, rb = _sparse_operand(rng, ncols, 8, dtype)
        c = a.multiply(b)
    else:
        b, rb = _sparse_operand(rng, 8, ncols, dtype)
        c = a.multiply(b, transpose=True)
        rb = rb.T.tocsr()
    assert (c.nrows, c.ncols) == (nrows, rb.shape[1])
    tolerance.check_sparse(c.to_scipy(), ref @ rb, abs_a @ abs(rb), dtype, op)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", OPS)
def test_xla_matches_scipy(op, shape):
    with use_kernel("xla"):
        _check(op, shape, np.float32)


@pytest.mark.parametrize("shape", ["nnz0", "hub_row", "empty_rows"])
@pytest.mark.parametrize("op", ["mult_vec", "mult_vec_t", "mult_dense",
                                "multiply"])
def test_xla_matches_scipy_f64(op, shape):
    with jax.enable_x64(True), use_kernel("xla"):
        _check(op, shape, np.float64)
