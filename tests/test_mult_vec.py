"""SpMV tests over all kernels (reference: tests/test_mult_vec.py)."""

import numpy as np
from hypothesis import given, settings
import hypothesis.strategies as st

from csr_tpu.kernels import use_kernel
from csr_tpu.test_utils import csrs, finite_arrays
from util import to_dense


@given(st.data())
def test_mult_vec(kernel, data):
    csr = data.draw(csrs())
    v = data.draw(finite_arrays(csr.ncols))
    dense = to_dense(csr)
    ref = dense @ v
    with use_kernel(kernel):
        y = np.asarray(csr.mult_vec(v))
    assert y.shape == (csr.nrows,)
    scale = max(1.0, np.abs(dense).max(initial=0) * np.abs(v).max(initial=0))
    np.testing.assert_allclose(y, ref, rtol=5e-4, atol=1e-4 * scale)


@given(st.data())
def test_mult_vec_structure_only(kernel, data):
    csr = data.draw(csrs(values=False))
    v = data.draw(finite_arrays(csr.ncols))
    ref = (to_dense(csr) != 0).astype(np.float64) @ v
    with use_kernel(kernel):
        y = np.asarray(csr.mult_vec(v))
    np.testing.assert_allclose(y, ref, rtol=5e-4, atol=1e-4 * max(1, np.abs(v).max(initial=0)))


def test_mult_vec_shape_mismatch(kernel):
    from csr_tpu import CSR

    m = CSR.empty(3, 4)
    with use_kernel(kernel):
        try:
            m.mult_vec(np.ones(5))
            assert False
        except AssertionError:
            pass


@given(st.data())
def test_mult_vec_t(kernel, data):
    """Transpose SpMV ``A^T v`` across all kernels (a contract extension;
    the reference reaches it via transpose + mult_vec,
    reference: csr/kernels/numba/multiply.py:41-57)."""
    csr = data.draw(csrs())
    v = data.draw(finite_arrays(csr.nrows))
    dense = to_dense(csr)
    ref = dense.T @ v
    with use_kernel(kernel):
        y = np.asarray(csr.mult_vec_t(v))
    assert y.shape == (csr.ncols,)
    scale = max(1.0, np.abs(dense).max(initial=0) * np.abs(v).max(initial=0))
    np.testing.assert_allclose(y, ref, rtol=5e-4, atol=1e-4 * scale)


@given(st.data())
def test_mult_vec_t_matches_transpose(kernel, data):
    """A^T v == transpose().mult_vec(v) — the structural identity the
    reference relies on."""
    csr = data.draw(csrs())
    v = data.draw(finite_arrays(csr.nrows))
    with use_kernel(kernel):
        y = np.asarray(csr.mult_vec_t(v))
        yt = np.asarray(csr.transpose().mult_vec(v))
    scale = max(1.0, np.abs(y).max(initial=0))
    np.testing.assert_allclose(y, yt, rtol=5e-4, atol=1e-4 * scale)


def test_mult_vec_t_sharded():
    """Capacity path: shrunken max_nnz forces per-shard transpose
    products summed over the column space."""
    import scipy.sparse as sps

    from csr_tpu.kernels import get_kernel

    rng = np.random.default_rng(3)
    m = sps.random(64, 40, 0.15, format="csr", random_state=rng,
                   dtype=np.float32)
    from csr_tpu import CSR

    csr = CSR.from_scipy(m)
    v = rng.standard_normal(64).astype(np.float32)
    ref = m.T @ v
    k = get_kernel("xla")
    old = k.max_nnz
    try:
        row_max = int(np.diff(np.asarray(csr.rowptrs)).max())
        k.max_nnz = max(row_max, 20)
        with use_kernel("xla"):
            y = np.asarray(csr.mult_vec_t(v))
    finally:
        k.max_nnz = old
    np.testing.assert_allclose(y, ref, rtol=5e-4, atol=1e-4)


@given(st.data())
def test_mult_vec_sharded(kernel, data):
    """Force the capacity-sharding path with a shrunken max_nnz
    (the reference's mkl_lim pattern, tests/test_mkl.py:29-38)."""
    csr = data.draw(csrs(nnz=st.integers(10, 200)))
    row_max = int(np.diff(np.asarray(csr.rowptrs)).max(initial=0))
    if row_max == 0:
        return
    from csr_tpu.kernels import get_kernel

    k = get_kernel(kernel)
    old = k.max_nnz
    try:
        k.max_nnz = max(row_max, 5)
        v = data.draw(finite_arrays(csr.ncols))
        ref = to_dense(csr) @ v
        with use_kernel(kernel):
            y = np.asarray(csr.mult_vec(v))
    finally:
        k.max_nnz = old
    scale = max(1.0, np.abs(ref).max(initial=0))
    np.testing.assert_allclose(y, ref, rtol=5e-4, atol=1e-4 * scale)


def test_sharded_layout_reuse():
    """Repeated over-capacity multiplies reuse the cached row shards: the
    shard list is cached on the matrix (identity-keyed on its buffers),
    so the second ``mult_vec`` slices nothing (the analog of the
    reference reusing B's handle across shards, reference:
    csr/csr.py:565), and an in-place change of the buffers invalidates
    the cache."""
    import scipy.sparse as sps

    from csr_tpu import CSR
    from csr_tpu.kernels import get_kernel, use_kernel

    rng = np.random.default_rng(7)
    m = sps.random(256, 192, 0.1, format="csr", random_state=rng)
    csr = CSR.from_scipy(m)
    v = rng.standard_normal(192).astype(np.float32)
    vt = rng.standard_normal(256).astype(np.float32)
    B = rng.standard_normal((192, 8)).astype(np.float32)

    k = get_kernel("xla")
    old = k.max_nnz
    try:
        k.max_nnz = max(int(np.diff(m.indptr).max()), csr.nnz // 3)
        with use_kernel("xla"):
            y1 = np.asarray(csr.mult_vec(v))
            shards = csr._shard_cache[4]
            assert len(shards) > 1  # the capacity path really sharded
            g1 = np.asarray(csr.mult_vec_t(vt))
            c1 = np.asarray(csr.mult_dense(B))
            assert csr._shard_cache[4] is shards
            y2 = np.asarray(csr.mult_vec(v))
            assert csr._shard_cache[4] is shards
            csr.sort_rows()  # replaces colinds -> the cache must miss
            y3 = np.asarray(csr.mult_vec(v))
            assert csr._shard_cache[4] is not shards
    finally:
        k.max_nnz = old
    np.testing.assert_allclose(y2, y1)
    np.testing.assert_allclose(y3, y1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y1, m @ v, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g1, m.T @ vt, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(c1, m @ B, rtol=1e-4, atol=1e-4)


def test_spmv_wide_3m_cols():
    """ncols ~ 3M on the default kernel: an operand far wider than the
    row count, sparse enough to stay fast on the CPU."""
    from csr_tpu import CSR
    from csr_tpu.kernels import get_kernel

    rng = np.random.default_rng(5)
    nrows, ncols, npr = 64, 3_000_000, 32
    nnz = nrows * npr
    rowptr = np.arange(nrows + 1, dtype=np.int64) * npr
    cols = np.sort(
        rng.choice(ncols, nnz, replace=True).astype(np.int32).reshape(
            nrows, npr
        ), axis=1,
    ).reshape(-1)
    vals = rng.standard_normal(nnz).astype(np.float32)
    csr = CSR(nrows, ncols, nnz, rowptr, cols, vals)
    x = rng.standard_normal(ncols).astype(np.float32)

    k = get_kernel()
    h = k.to_handle(csr)
    y = np.asarray(k.mult_vec(h, x))
    ref = np.zeros(nrows)
    for r in range(nrows):
        s = slice(r * npr, (r + 1) * npr)
        ref[r] = np.dot(vals[s].astype(np.float64), x[cols[s]])
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)
    k.release_handle(h)
