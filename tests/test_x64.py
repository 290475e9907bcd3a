"""
float64 / int64 parity under ``jax_enable_x64``.

The reference's MKL path is float64-only (reference:
csr/kernels/mkl/handle.py:69) and its tests assert f8 results at
rel=1e-5, abs=1e-10 (reference: tests/test_multiply.py:44).  JAX
narrows to 32 bits unless x64 is enabled, so the framework treats x64 as
an opt-in mode: these tests run inside ``jax.enable_x64`` and check
full-precision behavior, plus the int64-rowptr pickle round-trip
(reference: tests/test_pickle.py:28-47).
"""

import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.sparse as sps

from csr_tpu import CSR
from csr_tpu.kernels import use_kernel


@pytest.fixture
def x64():
    with jax.enable_x64():
        yield


def _mat(nrows=40, ncols=30, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    return sps.random(nrows, ncols, density, format="csr", random_state=rng)


def test_f64_values_preserved(x64):
    m = _mat()
    c = CSR.from_scipy(m)
    assert c.values.dtype == jnp.float64


def test_f64_mult_vec_precision(x64):
    m = _mat(seed=1)
    c = CSR.from_scipy(m)
    x = np.random.default_rng(2).standard_normal(c.ncols)
    with use_kernel("xla"):
        y = np.asarray(c.mult_vec(x))
    assert y.dtype == np.float64
    np.testing.assert_allclose(y, m @ x, rtol=1e-5, atol=1e-10)


def test_f64_multiply_precision(x64):
    a = _mat(30, 40, seed=3)
    b = _mat(40, 20, seed=4)
    ca, cb = CSR.from_scipy(a), CSR.from_scipy(b)
    with use_kernel("xla"):
        cc = ca.multiply(cb)
    ref = (a @ b).toarray()
    got = cc.to_scipy().toarray()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-10)


def test_f64_contract_ops(x64):
    """f64 through every contract op on the default kernel: the values stay
    f64 end to end (the reference normalizes to f64 for MKL, reference:
    csr/kernels/mkl/handle.py:69) and meet f64 tolerances."""
    m = _mat(seed=8)
    c = CSR.from_scipy(m)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(c.ncols)
    v = rng.standard_normal(c.nrows)
    B = rng.standard_normal((c.ncols, 5))
    y = np.asarray(c.mult_vec(x))
    g = np.asarray(c.mult_vec_t(v))
    C = np.asarray(c.mult_dense(B))
    assert y.dtype == g.dtype == C.dtype == np.float64
    np.testing.assert_allclose(y, m @ x, rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(g, m.T @ v, rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(C, m @ B, rtol=1e-5, atol=1e-10)


def test_f64_normalize_unit(x64):
    m = _mat(seed=5)
    c = CSR.from_scipy(m)
    norms = np.asarray(c.normalize_rows("unit"))
    dense = m.toarray()
    ref = np.linalg.norm(dense, axis=1)
    np.testing.assert_allclose(norms, ref, rtol=1e-5, atol=1e-10)


def test_int64_rowptr_pickle(x64):
    """int64 rowptrs survive a pickle round-trip
    (reference: tests/test_pickle.py test_csr64_pickle)."""
    m = _mat(seed=6)
    c = CSR.from_scipy(m)
    c64 = CSR(
        c.nrows, c.ncols, c.nnz,
        jnp.asarray(np.asarray(c.rowptrs), jnp.int64),
        c.colinds, c.values, _cast=False,
    )
    assert c64.rowptrs.dtype == jnp.int64
    c2 = pickle.loads(pickle.dumps(c64))
    assert c2.nnz == c64.nnz
    np.testing.assert_array_equal(np.asarray(c2.rowptrs), np.asarray(c64.rowptrs))
    np.testing.assert_array_equal(np.asarray(c2.colinds), np.asarray(c64.colinds))
