"""
Pluggable kernel backends (reference: csr/kernels/__init__.py).

A *kernel* provides the heavy compute operations behind :class:`csr_tpu.CSR`
through an 8-symbol contract (reference: docs/kernels.rst "Kernel
Interface"):

``to_handle, from_handle, release_handle, order_columns,
mult_vec, mult_ab, mult_abt, max_nnz``

``to_handle`` performs backend-specific preprocessing (for ``xla``, the
expansion of row pointers to per-entry row ids) in place of the
reference's MKL handle creation.  ``max_nnz`` is the per-operation
capacity; matrices above it are row-sharded by the caller
(reference: csr/csr.py:558-567).

Available kernels:

``xla``
    Pure JAX/XLA implementation, the default on every backend (CPU and
    GPU).  It plays the role of both the reference's ``numba`` kernel and
    its ``mkl`` vendor kernel; both names are aliases for it.

``scipy``
    SciPy host oracle, for testing and benchmarking only (reference:
    csr/kernels/scipy.py).

Selection: the ``CSR_KERNEL`` environment variable, else ``xla``
(reference: csr/kernels/__init__.py:100-117).  An unknown name raises
:class:`ImportError` naming the available kernels.
"""

from __future__ import annotations

import logging
import os
import threading
import warnings
from contextlib import contextmanager
from importlib import import_module

kernels = {}
__all__ = [
    "releasing",
    "set_kernel",
    "use_kernel",
    "get_kernel",
    "trace",
]

# Handle-lifecycle tracing (the role of the reference's compile-time
# LK_TRACE stderr tracing for handle-leak debugging, reference:
# csr/kernels/mkl/mkl_ops.c:57-58, tasks.py:49-51).  Enabled at runtime by
# the CSR_TPU_TRACE environment variable; kernels call ``trace()`` on
# handle creation/release and device-layout builds.
_TRACE = bool(os.environ.get("CSR_TPU_TRACE"))
_trace_log = logging.getLogger("csr_tpu.trace")
if _TRACE and not _trace_log.handlers:  # pragma: no cover - env-dependent
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("csr-tpu-trace: %(message)s"))
    _trace_log.addHandler(_h)
    _trace_log.setLevel(logging.INFO)


#: registered trace listeners (callables ``f(event, fields)``); always
#: dispatched, independent of CSR_TPU_TRACE — the hook behind
#: :func:`csr_tpu.utils.debug.check_handle_leaks`
_listeners: list = []


def trace(event: str, **fields):
    """Log a handle-lifecycle event when ``CSR_TPU_TRACE`` is set, and
    dispatch it to any registered listeners."""
    for listener in _listeners:
        listener(event, fields)
    if _TRACE:
        _trace_log.info(
            "%s %s", event, " ".join(f"{k}={v}" for k, v in fields.items())
        )


class ActiveKernel(threading.local):
    """Thread-local active kernel (reference: csr/kernels/__init__.py:16-29)."""

    def __init__(self):
        self.__dict__.update({"active_name": None})

    @property
    def active(self):
        kern = getattr(self, "_active", None)
        if kern is None:
            return _default_kernel()
        return kern

    def set_active(self, kern, name=None):
        self._active = kern
        self.active_name = name


__cached_default = None
__active = ActiveKernel()


@contextmanager
def releasing(h, k):
    """Context manager that releases a kernel handle on exit
    (reference: csr/kernels/__init__.py:36-41)."""
    try:
        yield h
    finally:
        k.release_handle(h)


def set_kernel(name):
    """
    Set the default kernel for the pure-Python API
    (reference: csr/kernels/__init__.py:44-63).

    Args:
        name(str): the name of the kernel, or ``None`` to restore automatic
            selection.
    """
    if name is None:
        __active.set_active(None, None)
    else:
        __active.set_active(get_kernel(name), name)


@contextmanager
def use_kernel(name):
    """Context manager to run code with a specified (thread-local) kernel
    (reference: csr/kernels/__init__.py:66-78)."""
    old = __active.active_name
    try:
        set_kernel(name)
        yield
    finally:
        set_kernel(old)


#: the kernel modules of this package
AVAILABLE = ("scipy", "xla")

_ALIASES = {
    # names from the reference map onto our backends so reference users'
    # CSR_KERNEL settings keep working
    "numba": "xla",
    "mkl": "xla",
}


def get_kernel(name=None):
    """
    Get a kernel by name, or the active default
    (reference: csr/kernels/__init__.py:81-97).
    """
    if name is None:
        return __active.active

    name = _ALIASES.get(name, name)
    kern = kernels.get(name, None)
    if not kern:
        if name not in AVAILABLE:
            raise ImportError(
                f"unknown kernel {name!r}; available kernels: "
                f"{', '.join(AVAILABLE)} (reference aliases: "
                f"{', '.join(_ALIASES)})"
            )
        kern = import_module(f"{__name__}.{name}")
        kernels[name] = kern
    return kern


def _initialize(name=None):
    global __cached_default
    if __cached_default:
        warnings.warn("default kernel already initialized")

    if not name:
        name = os.environ.get("CSR_KERNEL") or "xla"
    __cached_default = get_kernel(name)


def _default_kernel():
    if not __cached_default:
        _initialize()
    return __cached_default
