"""
Debug guards: catching silent host↔device transfers.

The reference's "sanitizer" story is thread-safety by construction plus
MKL's hard aborts (SURVEY §5); on an accelerator the hazard class is
different: *silent device↔host transfers* (a host numpy touch of a device
array stalls the pipeline).  This module wraps JAX's transfer guard as a
context manager scoped to sparse workloads.

Determinism note: the xla kernel's reductions (``segment_sum``, scatter-add)
are reproducible on the CPU, but on a GPU XLA may lower them to atomic
adds whose order, and so whose last bits, change from run to run.  Compare
results with the bounds of :mod:`csr_tpu.utils.tolerance`, not bitwise.
"""

from __future__ import annotations

from contextlib import contextmanager

import jax


@contextmanager
def guard_transfers(level: str = "disallow"):
    """Fail (or log) on implicit device↔host transfers inside the block.

    Levels: ``"allow"``, ``"log"``, ``"disallow"`` (see
    ``jax.transfer_guard``).  Explicit transfers (``jax.device_put``,
    ``np.asarray(x)`` on a committed array) are still permitted by JAX's
    guard semantics only when explicit — accidental implicit conversions
    raise.

    Example::

        with guard_transfers():
            y = a.mult_vec(x)      # any hidden host round-trip raises
    """
    with jax.transfer_guard(level):
        yield


@contextmanager
def check_handle_leaks(strict: bool = True):
    """Assert that every ``to_handle`` inside the block is balanced by a
    ``release_handle`` — the runtime analog of the reference's LK_TRACE
    handle-leak debugging workflow (reference: csr/kernels/mkl/mkl_ops.c
    alloc/free tracing, tasks.py:49-51), as a checkable invariant instead
    of stderr logs to eyeball.

    Device handles here hold device arrays (the expanded row ids); a
    leaked handle in a long-running serving loop pins device memory the
    same way a leaked MKL handle pinned host memory.

    Example::

        from csr_tpu.utils.debug import check_handle_leaks

        with check_handle_leaks():
            with releasing(K.to_handle(a), K) as h:
                y = K.mult_vec(h, x)

    With ``strict=False`` the context yields a counter object instead of
    raising; inspect ``counter.outstanding`` after the block.
    """
    from csr_tpu import kernels

    class Counter:
        def __init__(self):
            self.created = 0
            self.released = 0

        @property
        def outstanding(self) -> int:
            return self.created - self.released

        def __call__(self, event, fields):
            if event == "to_handle":
                self.created += 1
            elif event == "release_handle":
                self.released += 1

    counter = Counter()
    kernels._listeners.append(counter)
    try:
        yield counter
    except BaseException:
        kernels._listeners.remove(counter)
        raise  # an in-flight error outranks the leak report
    else:
        kernels._listeners.remove(counter)
        if strict and counter.outstanding != 0:
            raise AssertionError(
                f"handle leak: {counter.created} to_handle vs "
                f"{counter.released} release_handle inside the block"
            )
