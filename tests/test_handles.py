"""Kernel handle lifecycle tests (reference: tests/test_handles.py)."""

import numpy as np
from hypothesis import given

from csr_tpu.kernels import get_kernel, releasing
from csr_tpu.test_utils import csrs
from util import to_dense


@given(csrs())
def test_handle_roundtrip(kernel, csr):
    k = get_kernel(kernel)
    with releasing(k.to_handle(csr), k) as h:
        c2 = k.from_handle(h)
    np.testing.assert_allclose(to_dense(c2), to_dense(csr), rtol=1e-6)


@given(csrs())
def test_order_columns(kernel, csr):
    k = get_kernel(kernel)
    dense = to_dense(csr)
    with releasing(k.to_handle(csr), k) as h:
        k.order_columns(h)
        c2 = k.from_handle(h)
    rps = np.asarray(c2.rowptrs)
    cis = np.asarray(c2.colinds)
    for i in range(c2.nrows):
        assert np.all(np.diff(cis[rps[i] : rps[i + 1]]) >= 0)
    np.testing.assert_allclose(to_dense(c2), dense, rtol=1e-6)


def test_max_nnz(kernel):
    k = get_kernel(kernel)
    assert k.max_nnz > 0


def test_check_handle_leaks():
    """The leak checker counts to_handle/release_handle balance (the
    runtime analog of the reference's LK_TRACE leak debugging,
    reference: csr/kernels/mkl/mkl_ops.c alloc/free tracing)."""
    import pytest

    from csr_tpu import CSR
    from csr_tpu.kernels import get_kernel, releasing
    from csr_tpu.utils.debug import check_handle_leaks

    csr = CSR.from_coo([0, 1], [1, 0], [1.0, 2.0], (2, 2))
    K = get_kernel("xla")

    # balanced: high-level ops release their handles
    with check_handle_leaks() as c:
        csr.mult_vec(np.ones(2, np.float32))
    assert c.created >= 1 and c.outstanding == 0

    # a deliberate leak raises
    with pytest.raises(AssertionError, match="handle leak"):
        with check_handle_leaks():
            K.to_handle(csr)

    # non-strict mode reports instead
    with check_handle_leaks(strict=False) as c:
        h = K.to_handle(csr)
    assert c.outstanding == 1
    K.release_handle(h)

    # an in-flight exception is not masked by the leak report
    with pytest.raises(ValueError, match="boom"):
        with check_handle_leaks():
            K.to_handle(csr)
            raise ValueError("boom")
