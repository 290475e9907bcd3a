"""Conversion tests (reference: tests/test_convert.py)."""

import numpy as np
import scipy.sparse as sps
from hypothesis import given

from csr_tpu import CSR
from csr_tpu.test_utils import csrs, sparse_matrices
from util import to_dense


@given(sparse_matrices(max_shape=(120, 120)))
def test_from_scipy_roundtrip(mat):
    c = CSR.from_scipy(mat)
    assert c.nrows, c.ncols == mat.shape
    assert c.nnz == mat.nnz
    np.testing.assert_allclose(to_dense(c), mat.toarray(), rtol=1e-6)


@given(sparse_matrices(max_shape=(80, 80), format="coo"))
def test_from_scipy_other_format(mat):
    c = CSR.from_scipy(mat)
    np.testing.assert_allclose(to_dense(c), mat.toarray(), rtol=1e-6)


@given(csrs())
def test_to_scipy(csr):
    m = csr.to_scipy()
    assert sps.issparse(m)
    assert m.shape == (csr.nrows, csr.ncols)
    if csr.values is None:
        # structure-only densifies to 1s
        assert np.all(m.data == 1.0)


@given(csrs())
def test_coo_roundtrip(csr):
    rows = np.asarray(csr.rowinds())
    cols = np.asarray(csr.colinds)
    vals = None if csr.values is None else np.asarray(csr.values)
    c2 = CSR.from_coo(rows, cols, vals, (csr.nrows, csr.ncols))
    np.testing.assert_allclose(to_dense(c2), to_dense(csr), rtol=1e-6)


@given(csrs())
def test_normalize(csr):
    n = csr._normalize(np.float64, np.int64)
    assert n.values is not None
    assert n.values.dtype in (np.float32, np.float64)  # f64 truncates w/o x64
    np.testing.assert_allclose(to_dense(n), to_dense(csr), rtol=1e-6)
    n2 = csr._normalize(False)
    assert n2.values is None


def test_bcoo_roundtrip():
    """BCOO (JAX-native sparse) interop, the JAX-side analog of the
    reference's scipy round-trip (reference: tests/test_convert.py)."""
    import numpy as np
    import scipy.sparse as sps

    from csr_tpu import CSR

    rng = np.random.default_rng(4)
    m = sps.random(60, 45, 0.1, format="csr", random_state=rng,
                   dtype=np.float32)
    csr = CSR.from_scipy(m)
    b = csr.to_bcoo()
    assert b.shape == (60, 45)
    np.testing.assert_allclose(np.asarray(b.todense()), m.toarray(),
                               rtol=1e-6, atol=1e-6)
    back = CSR.from_bcoo(b)
    assert (back.to_scipy() != m).nnz == 0

    # structure-only matrices materialize implicit ones
    s = csr.copy(include_values=False)
    bs = s.to_bcoo()
    np.testing.assert_allclose(
        np.asarray(bs.todense()), (m.toarray() != 0).astype(np.float32)
    )


def test_to_bcoo_flags_honest():
    """CSR permits unsorted in-row columns and duplicate coordinates, so
    to_bcoo must not promise sorted/unique indices (they are undefined
    behavior when violated)."""
    from csr_tpu import CSR

    # unsorted columns within the row, plus a duplicate coordinate
    c = CSR.from_coo([0, 0, 0], [5, 2, 5], [1.0, 2.0, 3.0], (1, 8))
    b = c.to_bcoo()
    assert not b.indices_sorted
    assert not b.unique_indices
    # the duplicate still sums correctly when materialized
    np.testing.assert_allclose(
        np.asarray(b.todense()), to_dense(c), rtol=1e-6
    )


def test_from_bcoo_rejects_batched():
    import jax.numpy as jnp
    import pytest
    from jax.experimental import sparse as jsparse

    from csr_tpu import CSR

    dense = jnp.asarray(np.eye(4, dtype=np.float32))
    batched = jsparse.BCOO.fromdense(dense, n_batch=1)
    with pytest.raises(AssertionError):
        CSR.from_bcoo(batched)
