"""
Structure manipulation for device CSR matrices.

This module plays the role of the reference's ``csr/structure.py``, but the
algorithms are XLA-first: instead of sequential counting-sort loops
(reference: csr/structure.py:12-58) we use sorts, ``bincount`` and
``segment_sum``, which XLA compiles to fused device programs.

All functions here are *functional*: they return new arrays.  In-place
semantics of the public API (``CSR.sort_rows`` etc.) are provided at the
class level by rebinding fields.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .dtypes import COLIND_DTYPE, big_int, ptr_dtype


# ---------------------------------------------------------------------------
# helpers


@functools.partial(jax.jit, static_argnames=("nrows", "out_dtype"))
def _rowptrs_from_rows(rows, nrows: int, out_dtype):
    """Build row pointers from (unsorted) COO row indices via bincount+cumsum."""
    counts = jnp.bincount(rows, length=nrows).astype(out_dtype)
    rps = jnp.zeros(nrows + 1, dtype=out_dtype)
    return rps.at[1:].set(jnp.cumsum(counts))


@functools.partial(jax.jit, static_argnames=("nrows", "nnz"))
def _row_ids(rowptrs, nrows: int, nnz: int):
    """Expand row pointers to a per-entry row-index vector.

    Replaces the reference's sequential fill loop (csr/_rows.py:122-128).
    Formulation: scatter-add a 1 at each interior row boundary position
    (``rowptrs[1:nrows]``; empty rows contribute duplicates) and
    prefix-sum.  ``searchsorted`` is avoided: a vectorized binary search
    lowers to ~log2(nrows) rounds of nnz-sized gathers, where this is one
    nrows-sized scatter and one cumsum."""
    if nnz == 0:
        return jnp.zeros(0, dtype=jnp.int32)
    from .dtypes import x64_scope

    # boundary positions past INT32_MAX need true int64 scatter indices
    # (x64_scope keeps the bound constants from overflowing weak i32)
    with x64_scope(nnz > np.iinfo(np.int32).max):
        bnd = rowptrs[1:nrows]
        ind = jnp.zeros(nnz, jnp.int32).at[
            jnp.clip(bnd, 0, nnz - 1)
        ].add(jnp.where(bnd < nnz, 1, 0).astype(jnp.int32))
        return jnp.cumsum(ind)


def row_ids_for(csr) -> jnp.ndarray:
    """Row index of each stored entry of ``csr`` (COO row vector)."""
    return _row_ids(csr.rowptrs, csr.nrows, csr.nnz)


# ---------------------------------------------------------------------------
# COO -> CSR


@functools.partial(jax.jit, static_argnames=("nrows", "has_values"))
def _from_coo_jit(rows, cols, values, nrows: int, has_values: bool):
    rows = rows.astype(jnp.int32)
    cols = cols.astype(COLIND_DTYPE)
    # ONE sort with payloads co-sorted by the sort network, instead of a
    # stable argsort + permutation gathers.  The iota second key makes the
    # order total, so an unstable sort still keeps the input order of
    # entries within a row — matching the reference's two-pass counting
    # scatter (csr/structure.py:12-58).
    iota = jnp.arange(rows.shape[0], dtype=jnp.int32)
    ops = (rows, iota, cols) + ((values,) if has_values else ())
    sorted_ops = jax.lax.sort(ops, num_keys=2, is_stable=False)
    rps = _rowptrs_from_rows(rows, nrows, big_int())
    return rps, sorted_ops[2], sorted_ops[3] if has_values else None


def from_coo(nrows: int, rows, cols, values=None):
    """COO triple -> (rowptrs, colinds, values).

    Reference: csr/structure.py:61-67.  Host (numpy) inputs take the native
    C++ counting-sort path (:mod:`csr_tpu.native`); device arrays convert
    on-device via a single multi-operand sort.  Returns wide rowptrs; the
    caller (``CSR.__init__``) narrows them per the dtype policy.
    """
    if not isinstance(rows, jax.Array) and not isinstance(cols, jax.Array):
        from . import native

        host = native.from_coo(nrows, rows, cols, values)
        if host is not None:
            return host

    rows = jnp.asarray(rows)
    cols = jnp.asarray(cols)
    if values is None:
        rps, out_cols, _ = _from_coo_jit(rows, cols, rows, nrows, False)
        return rps, out_cols, None
    rps, out_cols, out_vals = _from_coo_jit(
        rows, cols, jnp.asarray(values), nrows, True
    )
    return rps, out_cols, out_vals


# ---------------------------------------------------------------------------
# transpose


@functools.partial(jax.jit, static_argnames=("nrows", "ncols", "has_values"))
def _transpose_jit(rowptrs, colinds, values, nrows: int, ncols: int,
                   has_values: bool):
    nnz = colinds.shape[0]
    rids = _row_ids(rowptrs, nrows, nnz)
    # ONE (col, row) 2-key sort with the values co-sorted by the sort
    # network — same output order as the reference's count-then-scatter
    # passes (csr/structure.py:172-237): row order preserved within each
    # column because (col, row) keys are a total order on distinct
    # coordinates (duplicate coordinates keep dense semantics; their
    # relative value order is unspecified, as after any COO round trip).
    ops = (colinds.astype(jnp.int32), rids) + ((values,) if has_values else ())
    sorted_ops = jax.lax.sort(ops, num_keys=2, is_stable=False)
    t_colinds = sorted_ops[1].astype(COLIND_DTYPE)
    t_rowptrs = _rowptrs_from_rows(colinds, ncols, rowptrs.dtype)
    return t_rowptrs, t_colinds, sorted_ops[2] if has_values else None


def transpose_arrays(rowptrs, colinds, values, nrows: int, ncols: int):
    """Transpose CSR arrays; returns (rowptrs, colinds, values) of the
    transpose (a ``ncols x nrows`` matrix)."""
    return _transpose_jit(rowptrs, colinds,
                          colinds if values is None else values,
                          nrows, ncols, values is not None)


# ---------------------------------------------------------------------------
# row sorting


@functools.partial(jax.jit, static_argnames=("nrows", "has_values"))
def _sort_rows_jit(rowptrs, colinds, values, nrows: int, has_values: bool):
    nnz = colinds.shape[0]
    rids = _row_ids(rowptrs, nrows, nnz)
    # Lexicographic (row, col) in ONE unstable 2-key sort with values
    # co-sorted, replacing the per-row bubble sort (csr/structure.py:156-169)
    # and the former two-stable-argsort + gather formulation.
    ops = (rids, colinds.astype(jnp.int32)) + ((values,) if has_values else ())
    sorted_ops = jax.lax.sort(ops, num_keys=2, is_stable=False)
    return (sorted_ops[1].astype(colinds.dtype),
            sorted_ops[2] if has_values else None)


def sort_rows_arrays(rowptrs, colinds, values, nrows: int):
    """Sort each row by increasing column index. Returns (colinds, values)."""
    return _sort_rows_jit(rowptrs, colinds,
                          colinds if values is None else values,
                          nrows, values is not None)


# ---------------------------------------------------------------------------
# row subsetting / picking


def subset_rows_arrays(csr, begin: int, end: int):
    """Subset rows [begin, end); shares device buffers via XLA slices.

    Reference: csr/structure.py:70-81.  The nnz of the result is data
    dependent, so this op syncs two rowptr scalars to the host.
    """
    sp = int(csr.rowptrs[begin])
    ep = int(csr.rowptrs[end])
    rps = csr.rowptrs[begin : end + 1] - sp
    cis = csr.colinds[sp:ep]
    vs = None if csr.values is None else csr.values[sp:ep]
    return rps, cis, vs, ep - sp


@functools.partial(jax.jit, static_argnames=("out_nnz",))
def _pick_rows_jit(rowptrs, rows, out_rps, out_nnz: int):
    nr = rows.shape[0]
    # output position -> which picked row it belongs to: scatter-add 1 at
    # each interior output-row boundary and prefix-sum (searchsorted
    # avoided — see _row_ids), with the row-start position recovered by a
    # cummax over boundary markers
    pos = jnp.arange(out_nnz, dtype=out_rps.dtype)
    bnd = out_rps[1:nr]
    ind = jnp.zeros(out_nnz, jnp.int32).at[
        jnp.clip(bnd, 0, out_nnz - 1)
    ].add(jnp.where(bnd < out_nnz, 1, 0).astype(jnp.int32))
    out_rid = jnp.cumsum(ind)
    start = jax.lax.cummax(jnp.where(ind > 0, pos, 0), axis=0)
    # source index = row start of the source row + offset within the row
    src_row = rows[out_rid]
    src_idx = rowptrs[src_row].astype(out_rps.dtype) + (pos - start)
    return src_idx


def pick_rows_arrays(csr, rows, include_values: bool = True):
    """Gather a (possibly repeating) selection of rows.

    Reference: csr/structure.py:85-153 (sequential copy loops) — here a
    single vectorized gather.
    """
    rows = jnp.asarray(rows, dtype=jnp.int32)
    nr = int(rows.shape[0])
    sizes = csr.rowptrs[rows + 1] - csr.rowptrs[rows]
    out_rps = jnp.zeros(nr + 1, dtype=big_int())
    out_rps = out_rps.at[1:].set(jnp.cumsum(sizes.astype(big_int())))
    out_nnz = int(out_rps[-1])
    src_idx = _pick_rows_jit(csr.rowptrs, rows, out_rps, out_nnz)
    cis = csr.colinds[src_idx]
    vs = None
    if include_values and csr.values is not None:
        vs = csr.values[src_idx]
    return out_rps.astype(ptr_dtype(out_nnz)), cis, vs, out_nnz


# ---------------------------------------------------------------------------
# nnz filtering / compaction


def filter_nnzs_arrays(csr, filt):
    """Keep only the entries where ``filt`` is True.

    Reference: csr/csr.py:494-522.  The output nnz is data dependent; we sync
    it once, then compact with a static-size ``nonzero`` gather.
    """
    filt = jnp.asarray(filt, dtype=bool)
    nnz2 = int(jnp.sum(filt))
    rps2, cis2, vs2 = _filter_compact(
        csr.rowptrs, csr.colinds, csr.values, filt, csr.nrows, nnz2
    )
    return rps2, cis2, vs2, nnz2


@functools.partial(jax.jit, static_argnames=("nrows", "nnz2"))
def _filter_compact(rowptrs, colinds, values, filt, nrows: int, nnz2: int):
    keep = jnp.nonzero(filt, size=nnz2)[0]
    rids = _row_ids(rowptrs, nrows, colinds.shape[0])
    counts = jax.ops.segment_sum(
        filt.astype(big_int()), rids, num_segments=nrows,
        indices_are_sorted=True,
    )
    rps2 = jnp.zeros(nrows + 1, dtype=big_int())
    rps2 = rps2.at[1:].set(jnp.cumsum(counts))
    vs2 = None if values is None else values[keep]
    return rps2.astype(ptr_dtype(nnz2)), colinds[keep], vs2


def assemble_shards_arrays(shards):
    """Concatenate row shards back into one matrix.

    Reference: csr/csr.py:623-650.
    """
    nrows = sum(s.nrows for s in shards)
    ncols = max(s.ncols for s in shards)
    nnz = sum(s.nnz for s in shards)
    dt = ptr_dtype(nnz)
    rp_parts = [jnp.zeros(1, dtype=dt)]
    off = 0
    for s in shards:
        rp_parts.append(s.rowptrs[1:].astype(dt) + off)
        off += s.nnz
    rps = jnp.concatenate(rp_parts)
    cis = jnp.concatenate([s.colinds for s in shards]) if nnz else jnp.zeros(0, COLIND_DTYPE)
    if shards[0].values is not None:
        vs = jnp.concatenate([s._required_values() for s in shards])
    else:
        vs = None
    return nrows, ncols, nnz, rps, cis, vs
