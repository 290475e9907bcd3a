"""
CSR as a first-class citizen of JAX transforms.

The JAX analog of the reference's Numba-mode suite (reference:
tests/test_numba.py, csr/_wiring.py): where the reference proves the CSR
type works inside ``@njit`` nopython code, these tests prove the pytree
registration makes CSR work across ``jax.jit`` boundaries and under
``vmap`` and ``grad`` — capabilities the reference's Numba identity has no
analog for.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.sparse as sps

from csr_tpu import CSR
from csr_tpu.kernels import use_kernel

from util import dense_tols


@pytest.fixture
def mat():
    rng = np.random.default_rng(42)
    m = sps.random(50, 40, 0.15, format="csr", random_state=rng)
    return CSR.from_scipy(m), m.toarray().astype(np.float32)


def test_csr_through_jit_boundary(mat):
    """A CSR passes into and out of a jitted function as a pytree."""
    csr, dense = mat

    @jax.jit
    def scale(c, a):
        return CSR(c.nrows, c.ncols, c.nnz, c.rowptrs, c.colinds,
                   c.values * a, _cast=False)

    out = scale(csr, 2.0)
    assert isinstance(out, CSR)
    assert (out.nrows, out.ncols, out.nnz) == (csr.nrows, csr.ncols, csr.nnz)
    np.testing.assert_allclose(
        np.asarray(out.values), 2.0 * np.asarray(csr.values), rtol=1e-6
    )


def test_csr_structure_only_pytree(mat):
    """Structure-only CSRs (values=None) flatten/unflatten cleanly."""
    csr, _ = mat
    s = csr.copy(include_values=False)
    leaves, treedef = jax.tree_util.tree_flatten(s)
    assert len(leaves) == 2  # rowptrs, colinds; values leaf absent
    r = jax.tree_util.tree_unflatten(treedef, leaves)
    assert r.values is None
    assert r.nnz == csr.nnz


def test_mult_vec_traced(mat):
    """CSR.mult_vec works on a traced CSR inside jit (xla kernel)."""
    csr, dense = mat
    x = np.random.default_rng(0).standard_normal(csr.ncols).astype(np.float32)

    with use_kernel("xla"):
        @jax.jit
        def f(c, v):
            return c.mult_vec(v)

        y = f(csr, jnp.asarray(x))
    ref = dense @ x
    np.testing.assert_allclose(np.asarray(y), ref, **dense_tols(ref, np.float32))


def test_mult_dense_traced(mat):
    csr, dense = mat
    B = np.random.default_rng(1).standard_normal((csr.ncols, 8)).astype(np.float32)

    with use_kernel("xla"):
        y = jax.jit(lambda c, b: c.mult_dense(b))(csr, jnp.asarray(B))
    ref = dense @ B
    np.testing.assert_allclose(np.asarray(y), ref, **dense_tols(ref, np.float32))


def test_row_ops_traced(mat):
    """Row densification works on traced CSRs (reference: csr/_rows.py)."""
    csr, dense = mat

    @jax.jit
    def f(c):
        return c.row(3), c.row_mask(3)

    r, m = f(csr)
    np.testing.assert_allclose(np.asarray(r), dense[3], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(m), dense[3] != 0)


def test_vmap_mult_vec(mat):
    """vmap over a batch of dense vectors with one shared CSR."""
    csr, dense = mat
    X = np.random.default_rng(2).standard_normal((5, csr.ncols)).astype(np.float32)

    with use_kernel("xla"):
        Y = jax.vmap(lambda v: csr.mult_vec(v))(jnp.asarray(X))
    ref = X @ dense.T
    np.testing.assert_allclose(np.asarray(Y), ref, **dense_tols(ref, np.float32))


def test_grad_through_mult_vec(mat):
    """SpMV is differentiable wrt both the values and the operand — a
    capability with no reference analog (Numba kernels are opaque)."""
    csr, dense = mat
    rng = np.random.default_rng(3)
    x = rng.standard_normal(csr.ncols).astype(np.float32)
    w = rng.standard_normal(csr.nrows).astype(np.float32)

    with use_kernel("xla"):

        def loss(c, v):
            return jnp.vdot(jnp.asarray(w), c.mult_vec(v))

        # allow_int: the CSR pytree carries integer index leaves, which get
        # symbolic-zero tangents
        gc, gx = jax.grad(loss, argnums=(0, 1), allow_int=True)(
            csr, jnp.asarray(x)
        )

    # d/dx (w^T A x) = A^T w
    ref_gx = dense.T @ w
    np.testing.assert_allclose(
        np.asarray(gx), ref_gx, **dense_tols(ref_gx, np.float32)
    )
    # d/dvalues: for stored entry (r, c): w[r] * x[c]
    rows = np.repeat(
        np.arange(csr.nrows), np.diff(np.asarray(csr.rowptrs))
    )
    ref_gv = w[rows] * x[np.asarray(csr.colinds)]
    np.testing.assert_allclose(
        np.asarray(gc.values), ref_gv, **dense_tols(ref_gv, np.float32)
    )


def test_static_kernel_module_traced(mat):
    """The frozen-default kernel module works inside jit — the analog of
    reference @njit client code calling csr.kernel.* (reference:
    csr/kernel.py:5-16, tests/test_numba.py)."""
    csr, dense = mat
    from csr_tpu.kernels import get_kernel

    K = get_kernel("xla")
    x = np.random.default_rng(4).standard_normal(csr.ncols).astype(np.float32)

    @jax.jit
    def f(c, v):
        h = K.to_handle(c)
        try:
            return K.mult_vec(h, v)
        finally:
            K.release_handle(h)

    y = f(csr, jnp.asarray(x))
    ref = dense @ x
    np.testing.assert_allclose(np.asarray(y), ref, **dense_tols(ref, np.float32))


def test_from_coo_traced():
    """Constructing a CSR from traced COO arrays inside jit."""
    rng = np.random.default_rng(5)
    rows = np.sort(rng.integers(0, 20, 60)).astype(np.int32)
    cols = rng.integers(0, 30, 60).astype(np.int32)
    vals = rng.standard_normal(60).astype(np.float32)

    @jax.jit
    def build_and_apply(r, c, v, x):
        m = CSR.from_coo(r, c, v, shape=(20, 30))
        return m.mult_vec(x)

    x = rng.standard_normal(30).astype(np.float32)
    with use_kernel("xla"):
        y = build_and_apply(rows, cols, vals, jnp.asarray(x))

    dense = np.zeros((20, 30), np.float32)
    np.add.at(dense, (rows, cols), vals)
    ref = dense @ x
    np.testing.assert_allclose(np.asarray(y), ref, **dense_tols(ref, np.float32))
