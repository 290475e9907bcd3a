"""SpMM (sparse x dense) tests over all kernels.

``mult_dense`` is an extension of the reference's kernel contract.
"""

import numpy as np
from hypothesis import given
import hypothesis.strategies as st

from csr_tpu.kernels import use_kernel
from csr_tpu.test_utils import csrs, finite_arrays
from util import to_dense


@given(st.data())
def test_mult_dense(kernel, data):
    csr = data.draw(csrs())
    n = data.draw(st.integers(1, 20))
    B = data.draw(finite_arrays((csr.ncols, n)))
    ref = to_dense(csr) @ B
    with use_kernel(kernel):
        C = np.asarray(csr.mult_dense(B))
    assert C.shape == (csr.nrows, n)
    scale = max(1.0, np.abs(ref).max(initial=0))
    np.testing.assert_allclose(C, ref, rtol=5e-4, atol=1e-4 * scale)


@given(st.data())
def test_mult_dense_structure_only(kernel, data):
    csr = data.draw(csrs(values=False))
    B = data.draw(finite_arrays((csr.ncols, 3)))
    ref = (to_dense(csr) != 0).astype(float) @ B
    with use_kernel(kernel):
        C = np.asarray(csr.mult_dense(B))
    scale = max(1.0, np.abs(ref).max(initial=0))
    np.testing.assert_allclose(C, ref, rtol=5e-4, atol=1e-4 * scale)


@given(st.data())
def test_mult_dense_sharded(kernel, data):
    csr = data.draw(csrs(nnz=st.integers(10, 150)))
    row_max = int(np.diff(np.asarray(csr.rowptrs)).max(initial=0))
    if row_max == 0:
        return
    from csr_tpu.kernels import get_kernel

    k = get_kernel(kernel)
    old = k.max_nnz
    try:
        k.max_nnz = max(row_max, 5)
        B = data.draw(finite_arrays((csr.ncols, 4)))
        ref = to_dense(csr) @ B
        with use_kernel(kernel):
            C = np.asarray(csr.mult_dense(B))
    finally:
        k.max_nnz = old
    scale = max(1.0, np.abs(ref).max(initial=0))
    np.testing.assert_allclose(C, ref, rtol=5e-4, atol=1e-4 * scale)
