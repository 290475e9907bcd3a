"""Kernel registry tests (reference: tests/test_active_kernel.py)."""

import pytest

from csr_tpu.kernels import get_kernel, set_kernel, use_kernel


def test_get_kernel_by_name():
    k = get_kernel("xla")
    assert k.__name__.endswith("xla")


def test_get_default():
    k = get_kernel()
    assert hasattr(k, "mult_vec")
    assert hasattr(k, "max_nnz")


def test_set_kernel():
    try:
        set_kernel("scipy")
        k = get_kernel()
        assert k.__name__.endswith("scipy")
    finally:
        set_kernel(None)


def test_use_kernel_restores():
    before = get_kernel()
    with use_kernel("scipy"):
        assert get_kernel().__name__.endswith("scipy")
        with use_kernel("xla"):
            assert get_kernel().__name__.endswith("xla")
        assert get_kernel().__name__.endswith("scipy")
    assert get_kernel() is before


def test_reference_aliases():
    """Reference kernel names map onto our backends: both the reference's
    portable and vendor kernels resolve to ``xla``."""
    assert get_kernel("numba").__name__.endswith("xla")
    assert get_kernel("mkl").__name__.endswith("xla")


def test_unknown_kernel():
    with pytest.raises(ImportError):
        get_kernel("definitely_not_a_kernel")


def test_kernel_module_contract():
    """Every backend exposes the full 8-symbol contract
    (reference: docs/kernels.rst)."""
    from csr_tpu.kernels import AVAILABLE

    for name in AVAILABLE:
        k = get_kernel(name)
        for sym in (
            "to_handle", "from_handle", "release_handle", "order_columns",
            "mult_vec", "mult_ab", "mult_abt", "max_nnz",
        ):
            assert hasattr(k, sym), (name, sym)


def test_trace_events(monkeypatch, caplog):
    """CSR_TPU_TRACE-style handle tracing emits lifecycle events
    (the analog of the reference's LK_TRACE handle-leak tracing,
    reference: csr/kernels/mkl/mkl_ops.c:57-58)."""
    import logging

    import numpy as np

    import csr_tpu.kernels as K
    from csr_tpu import CSR

    monkeypatch.setattr(K, "_TRACE", True)
    c = CSR.from_coo(np.array([0, 1]), np.array([1, 0]),
                     np.array([1.0, 2.0]), (2, 2))
    with caplog.at_level(logging.INFO, logger="csr_tpu.trace"):
        with K.use_kernel("xla"):
            c.mult_vec(np.ones(2))
    events = [r.message.split()[0] for r in caplog.records]
    assert "to_handle" in events
    assert "release_handle" in events


def test_guard_transfers():
    """Transfer guard catches implicit host->device conversions inside
    compute (SURVEY §5 race/sanitizer analog)."""
    import numpy as np
    import pytest

    import jax.numpy as jnp

    from csr_tpu.utils.debug import guard_transfers

    dev = jnp.arange(4.0)
    two = jnp.asarray(2.0)
    with guard_transfers("disallow"):
        _ = dev * two  # pure device compute is fine
        with pytest.raises(Exception):
            _ = dev + np.arange(4.0)  # implicit host transfer must raise


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_default_kernel_on_any_backend(monkeypatch, backend):
    """The default kernel is ``xla`` whatever backend JAX reports."""
    import jax

    import csr_tpu.kernels as K

    monkeypatch.delenv("CSR_KERNEL", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(K, "__cached_default", None)
    K._initialize()
    assert K._default_kernel().__name__ == "csr_tpu.kernels.xla"


def test_csr_kernel_pallas_raises(monkeypatch):
    """``CSR_KERNEL=pallas`` names a removed backend: selecting it raises
    an error that lists the available kernels."""
    import csr_tpu.kernels as K

    monkeypatch.setenv("CSR_KERNEL", "pallas")
    monkeypatch.setattr(K, "__cached_default", None)
    with pytest.raises(ImportError, match="available kernels: scipy, xla"):
        K._initialize()
