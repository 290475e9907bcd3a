"""
Data-type policy for device CSR matrices.

Mirrors the reference dtype rules (reference: csr/csr.py:88-95): column
indices are always ``int32``; row pointers are ``int32`` unless the matrix
has more than ``INT32_MAX`` stored entries, in which case they are
``int64``; values may be any floating dtype.

JAX narrows float64 to float32 unless ``jax_enable_x64`` is set, so values
keep the dtype of the data we are given (usually float32) instead of being
forced to float64 the way the reference forces f8 for MKL
(reference: csr/kernels/mkl/handle.py:69).  Enable ``jax_enable_x64`` for
float64 work.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

INT32_MAX = np.iinfo(np.int32).max

#: dtype used for column indices (reference uses np.intc, csr/csr.py:89)
COLIND_DTYPE = jnp.int32


def ptr_dtype(nnz: int):
    """Row-pointer dtype for a matrix with ``nnz`` stored entries
    (reference: csr/csr.py:90-93)."""
    return jnp.int32 if nnz <= INT32_MAX else jnp.int64


def x64_enabled() -> bool:
    import jax

    return bool(jax.config.read("jax_enable_x64"))


def canon_float(dtype) -> jnp.dtype:
    """Canonicalize a value dtype under the current x64 setting."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float64 and not x64_enabled():
        return jnp.dtype(jnp.float32)
    return dtype


def big_int():
    """Widest available integer dtype: int64 under x64, else int32.

    Used for cumulative sums that could exceed int32 only on matrices that
    require x64 anyway (nnz > INT32_MAX forces int64 rowptrs)."""
    return jnp.int64 if x64_enabled() else jnp.int32


def x64_scope(needed: bool = True):
    """Context manager permitting true int64 array creation.

    JAX silently narrows int64 to int32 unless ``jax_enable_x64`` is set —
    which would corrupt row pointers past INT32_MAX entries.  Wrapping the
    (rare) conversions that genuinely need 64 bits in this scope creates
    honest int64 arrays without flipping the global precision mode the way
    the reference's dtype rules never had to (reference: csr/csr.py:88-93
    promote unconditionally; numpy has no narrowing mode)."""
    import contextlib

    if needed and not x64_enabled():
        import jax

        return jax.enable_x64(True)
    return contextlib.nullcontext()


def default_value_dtype():
    """The dtype produced for implicit (structure-only) values.

    The reference produces float64 (csr/csr.py:251); here float64 only
    when x64 is enabled, float32 otherwise.
    """
    return jnp.float64 if x64_enabled() else jnp.float32
