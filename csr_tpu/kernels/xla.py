"""
Pure-XLA kernel backend: the default on every backend.

It plays the role the ``numba`` kernel plays in the reference
(reference: csr/kernels/numba/__init__.py): self-contained, always
available, and compiled by XLA for whichever device JAX runs on.

Design notes
------------

* SpMV is ``segment_sum(values * v[colinds], row_ids)`` — the XLA-native
  formulation of the reference's flat nnz loop
  (reference: csr/kernels/numba/__init__.py:55-67).
* SpGEMM densifies the *output* while the dense intermediates fit
  :func:`csr_tpu.ops.spgemm.dense_fits`: ``C = A @ B`` is a scatter-add of
  ``values_i * B[col_i, :]`` into a dense ``(nrows, B.ncols)``
  accumulator, compacted back to CSR.  Larger products run
  expand-sort-compress (:mod:`csr_tpu.ops.spgemm`).  Both replace the
  reference's SMMP symbolic/numeric passes
  (reference: csr/kernels/numba/multiply.py:60-129), whose linked-list
  column marking does not vectorize.
* Handles carry the expanded COO row-id vector, the analog of the
  reference's preprocessing in ``to_handle``.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from csr_tpu import dtypes, structure
from csr_tpu.dtypes import big_int
from csr_tpu.kernels import trace
from csr_tpu.ops import spgemm as _esc

max_nnz = np.iinfo("i8").max


class XlaHandle:
    """Device-resident handle: CSR arrays + precomputed COO row ids."""

    __slots__ = ("csr", "row_ids")

    def __init__(self, csr, row_ids):
        self.csr = csr
        self.row_ids = row_ids


def to_handle(csr):
    """Preprocess a CSR for compute: expand row ids
    (kernel contract, reference: docs/kernels.rst)."""
    trace("to_handle", kernel="xla", shape=(csr.nrows, csr.ncols), nnz=csr.nnz)
    return XlaHandle(csr, structure.row_ids_for(csr))


def from_handle(h):
    """Handle -> CSR; device buffers are shared."""
    from csr_tpu import CSR

    c = h.csr
    return CSR(c.nrows, c.ncols, c.nnz, c.rowptrs, c.colinds, c.values, _cast=False)


def release_handle(h):
    """Release a handle.  JAX buffers are GC-managed; nothing to free."""
    trace("release_handle", kernel="xla", nnz=h.csr.nnz)


def order_columns(h):
    """Sort each row of the handle's matrix by column, in place."""
    h.csr.sort_rows()


def _result_dtype(*dts):
    dt = functools.reduce(jnp.promote_types, dts)
    if not jnp.issubdtype(dt, jnp.floating):
        dt = jnp.float32
    return jnp.promote_types(dt, jnp.float32)


@functools.partial(jax.jit, static_argnames=("nrows", "out_dtype"))
def _spmv(values, colinds, row_ids, v, nrows: int, out_dtype):
    prod = values.astype(out_dtype) * v.astype(out_dtype)[colinds]
    return jax.ops.segment_sum(
        prod, row_ids, num_segments=nrows, indices_are_sorted=True
    )


def mult_vec(h, v):
    """SpMV ``A @ v`` (reference: csr/kernels/numba/__init__.py:55-67)."""
    c = h.csr
    vals = c._required_values()
    out_dtype = _result_dtype(vals.dtype, v.dtype)
    return _spmv(vals, c.colinds, h.row_ids, v, c.nrows, out_dtype)


@functools.partial(jax.jit, static_argnames=("ncols", "out_dtype"))
def _spmv_t(values, colinds, row_ids, v, ncols: int, out_dtype):
    prod = values.astype(out_dtype) * v.astype(out_dtype)[row_ids]
    return jax.ops.segment_sum(prod, colinds.astype(jnp.int32),
                               num_segments=ncols)


def mult_vec_t(h, v):
    """Transpose SpMV ``A^T @ v`` (a contract extension; the reference
    reaches it structurally via transpose + mult_vec,
    reference: csr/kernels/numba/multiply.py:41-57)."""
    c = h.csr
    vals = c._required_values()
    v = jnp.asarray(v)
    out_dtype = _result_dtype(vals.dtype, v.dtype)
    return _spmv_t(vals, c.colinds, h.row_ids, v, c.ncols, out_dtype)


@functools.partial(jax.jit, static_argnames=("nrows", "ncols", "out_dtype"))
def _spgemm_dense(a_vals, a_cols, a_rids, b_dense, nrows: int, ncols: int, out_dtype):
    """Dense-accumulator SpGEMM: C[r] += a_i * B[c_i, :]."""
    contrib = a_vals.astype(out_dtype)[:, None] * b_dense.astype(out_dtype)[a_cols]
    out = jnp.zeros((nrows, ncols), dtype=out_dtype)
    return out.at[a_rids].add(contrib, indices_are_sorted=True)


@functools.partial(jax.jit, static_argnames=("nrows", "ncols", "out_dtype"))
def _densify(vals, cols, rids, nrows: int, ncols: int, out_dtype):
    out = jnp.zeros((nrows, ncols), dtype=out_dtype)
    return out.at[rids, cols].add(vals.astype(out_dtype), indices_are_sorted=True)


@functools.partial(jax.jit, static_argnames=("nnz",))
def _dense_compact(dense, nnz: int):
    mask = dense != 0
    rids, cols = jnp.nonzero(mask, size=nnz)
    vals = dense[rids, cols]
    rps = jnp.zeros(dense.shape[0] + 1, dtype=big_int())
    counts = jnp.sum(mask, axis=1, dtype=big_int())
    rps = rps.at[1:].set(jnp.cumsum(counts))
    return rps, cols.astype(dtypes.COLIND_DTYPE), vals


def dense_to_csr(dense):
    """Compact a dense matrix to CSR, keeping nonzero entries.

    Matches the reference's post-multiply ``_filter_zeros`` semantics
    (reference: csr/csr.py:553-556): the result stores exactly the
    nonzero entries, in row-major (column-sorted) order.  The output nnz
    is synced to the host once; the compaction is one jitted program.
    """
    from csr_tpu import CSR

    nrows, ncols = dense.shape
    nnz = int(jnp.sum(dense != 0))
    rps, cols, vals = _dense_compact(dense, nnz)
    return CSR(nrows, ncols, nnz, rps, cols, vals)


def mult_dense(h, B):
    """SpMM ``A @ B`` with dense ``B`` (a contract extension)."""
    c = h.csr
    vals = c._required_values()
    B = jnp.asarray(B)
    out_dtype = _result_dtype(vals.dtype, B.dtype)
    return _spgemm_dense(
        vals, c.colinds, h.row_ids, B, c.nrows, B.shape[1], out_dtype
    )


def mult_ab(a_h, b_h):
    """SpGEMM ``A @ B`` via dense accumulation when the dense
    intermediates fit the memory budget, ESC otherwise
    (replaces SMMP, reference: csr/kernels/numba/multiply.py:13-38)."""
    a, b = a_h.csr, b_h.csr
    assert a.ncols == b.nrows
    a_vals = a._required_values()
    b_vals = b._required_values()
    out_dtype = _result_dtype(a_vals.dtype, b_vals.dtype)
    if not _esc.dense_fits(a.nrows, b.nrows, b.ncols, b.ncols):
        return to_handle(_esc.esc_mult_ab(a, b, out_dtype))
    b_dense = _densify(b_vals, b.colinds, b_h.row_ids, b.nrows, b.ncols, out_dtype)
    c_dense = _spgemm_dense(
        a_vals, a.colinds, a_h.row_ids, b_dense, a.nrows, b.ncols, out_dtype
    )
    return to_handle(dense_to_csr(c_dense))


def mult_abt(a_h, b_h):
    """SpGEMM ``A @ B^T`` (reference: csr/kernels/numba/multiply.py:41-57)."""
    a, b = a_h.csr, b_h.csr
    assert a.ncols == b.ncols
    a_vals = a._required_values()
    b_vals = b._required_values()
    out_dtype = _result_dtype(a_vals.dtype, b_vals.dtype)
    if not _esc.dense_fits(a.nrows, b.nrows, b.ncols, b.nrows):
        return to_handle(_esc.esc_mult_abt(a, b, out_dtype))
    bt_dense = _densify(b_vals, b.colinds, b_h.row_ids, b.nrows, b.ncols, out_dtype).T
    c_dense = _spgemm_dense(
        a_vals, a.colinds, a_h.row_ids, bt_dense, a.nrows, b.nrows, out_dtype
    )
    return to_handle(dense_to_csr(c_dense))
