"""
SciPy host "kernel" (reference: csr/kernels/scipy.py).

This kernel is the correctness oracle for tests and benchmarks: it pulls
data back to the host and uses :mod:`scipy.sparse`.  It is never selected
as the default.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix

from csr_tpu.kernels import trace

max_nnz = np.iinfo("i8").max


def to_handle(csr):
    """CSR -> scipy.sparse.csr_matrix on the host
    (reference: csr/kernels/scipy.py:15-19)."""
    trace("to_handle", kernel="scipy", shape=(csr.nrows, csr.ncols),
          nnz=csr.nnz)
    values = csr.values
    if values is None:
        values = np.ones(csr.nnz)
    else:
        # copy: device buffers surface as read-only host views, and scipy
        # mutates in place (e.g. sort_indices)
        values = np.array(values)
    return csr_matrix(
        (values, np.array(csr.colinds), np.array(csr.rowptrs)),
        (csr.nrows, csr.ncols),
    )


def from_handle(h):
    """scipy matrix -> device CSR (reference: csr/kernels/scipy.py:22-25)."""
    from csr_tpu import CSR

    m = h.tocsr()
    nr, nc = m.shape
    return CSR(nr, nc, m.nnz, m.indptr, m.indices, m.data)


def order_columns(h):
    h.sort_indices()


def release_handle(h):
    trace("release_handle", kernel="scipy", nnz=h.nnz)


def mult_ab(A, B):
    return A @ B


def mult_abt(A, B):
    return A @ B.T


def mult_vec(A, v):
    import jax.numpy as jnp

    return jnp.asarray(A @ np.asarray(v))


def mult_vec_t(A, v):
    """Transpose SpMV ``A^T @ v`` (a contract extension)."""
    import jax.numpy as jnp

    return jnp.asarray(A.T @ np.asarray(v))


def mult_dense(A, B):
    """SpMM with a dense right-hand side (a contract extension)."""
    import jax.numpy as jnp

    return jnp.asarray(A @ np.asarray(B))
