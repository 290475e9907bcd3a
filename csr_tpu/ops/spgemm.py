"""
Capacity-safe sparse x sparse multiply (ESC formulation).

The dense-routing SpGEMM (:mod:`csr_tpu.kernels.xla`) densifies B and
the product C, which needs both to fit in memory.  This module is the
other half of the capacity contract: when either dense form exceeds
:data:`max_dense_elems`, products are computed by
**expand-sort-compress** (ESC), the vector-hardware replacement for the
reference's SMMP symbolic/numeric linked-list passes
(reference: csr/kernels/numba/multiply.py:60-129):

1. **expand** — every product term ``A[i,k] * B[k,j]`` becomes one COO
   triple.  The expansion size ``E = sum_e nnz(B row col(e))`` is exact
   and computed up front (the analog of SMMP's symbolic pass, but a
   single segment-gather instead of a per-row linked-list walk).
2. **sort** — lexicographic (row, col) via two stable device sorts,
   making duplicate output coordinates adjacent.
3. **compress** — boundary flags + segment-sum collapse duplicates;
   rowptrs come from a bincount.

Memory is bounded twice over: ``E`` never materializes more than
:data:`esc_chunk_entries` triples at a time (A is processed in row
chunks, the direct descendant of the reference's capacity row-sharding,
reference: csr/csr.py:558-567), and no dense (n x m) array is ever
created.  Output nnz is data-dependent, so each chunk syncs one scalar
to the host — the same recompilation boundary the dense path's
``dense_to_csr`` already has.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

from csr_tpu import dtypes, structure
from csr_tpu.dtypes import COLIND_DTYPE, big_int

#: largest dense intermediate (elements) the dense-routing SpGEMM may
#: allocate; beyond this products go through ESC.  2**27 f32 elements =
#: 512 MiB.  Monkeypatchable (the ``mkl_lim`` test pattern, reference:
#: tests/test_mkl.py:29-38) and overridable via CSR_TPU_DENSE_ELEMS.
max_dense_elems = int(os.environ.get("CSR_TPU_DENSE_ELEMS", 2**27))

#: expansion triples materialized per ESC chunk (~16 B each).
esc_chunk_entries = int(os.environ.get("CSR_TPU_ESC_CHUNK", 2**24))


def dense_fits(a_nrows: int, b_nrows: int, b_ncols: int, n_out: int) -> bool:
    """Can the dense-routing SpGEMM afford its intermediates?

    It materializes dense B (or B^T) and the dense product C; both must
    fit the budget."""
    return (
        b_nrows * b_ncols <= max_dense_elems
        and a_nrows * n_out <= max_dense_elems
    )


_SENT = np.int32(2**31 - 1)  # padding sentinel: sorts after every real row


def _bucket(n: int, floor: int = 4096) -> int:
    """Round ``n`` up to a power of two (>= floor).

    ``_expand``/``_compress`` are jitted on static sizes; data-dependent
    chunk sizes would recompile the multi-million-element sort pipeline
    per chunk (round-3 verdict item 6).  Power-of-two padding makes the
    compile count logarithmic in the size range — a large product with
    budget-sized chunks compiles each stage once or twice."""
    return max(floor, 1 << max(int(n) - 1, 0).bit_length())


@functools.partial(jax.jit, static_argnames=("n_pad", "out_dtype"))
def _expand(a_vals, a_cols, a_rids, b_rps, b_cols, b_vals, ex_cum,
            n_valid, n_pad: int, out_dtype):
    """Materialize and sort the expansion triples for one chunk.

    ``n_pad`` (static) is the bucket-padded triple count; ``n_valid``
    (traced) the true expansion size.  Padding triples carry sentinel
    coordinates and zero values, so they sort to the tail and never set a
    boundary flag.  Returns (rows, cols, vals) sorted lexicographically
    by (row, col), plus the new-coordinate boundary flags."""
    nnz_a = a_cols.shape[0]
    t = jnp.arange(n_pad, dtype=ex_cum.dtype)
    valid = t < n_valid
    # which A entry each triple expands from: scatter a 1 at each entry's
    # start offset and prefix-sum, instead of a vectorized binary search
    # over ex_cum (searchsorted = ~log2(nnz_a) rounds of full-size
    # gathers; the scatter is nnz_a-sized and the cumsum one pass)
    assert nnz_a > 0  # _esc_rows returns early for empty A
    starts = jnp.concatenate([jnp.zeros(1, ex_cum.dtype), ex_cum[:-1]])
    ind = jnp.zeros(n_pad, jnp.int32).at[
        jnp.minimum(starts, n_pad - 1)
    ].add(jnp.where(starts < n_pad, 1, 0).astype(jnp.int32))
    e = jnp.minimum(jnp.cumsum(ind) - 1, nnz_a - 1)
    # offset of t within its entry's run = t - (last start position <= t)
    start = jax.lax.cummax(jnp.where(ind > 0, t, 0), axis=0)
    off = t - start
    src = b_rps[a_cols[e]].astype(ex_cum.dtype) + off
    src = jnp.clip(src, 0, max(b_cols.shape[0] - 1, 0))

    rows = jnp.where(valid, a_rids[e], _SENT)
    cols = jnp.where(valid, b_cols[src].astype(jnp.int32), _SENT)
    vals = jnp.where(
        valid, a_vals.astype(out_dtype)[e] * b_vals.astype(out_dtype)[src], 0
    )

    # lexicographic (row, col) in ONE sort pass, values co-sorted: a
    # 2-key lax.sort replaces the former stable argsort-by-col +
    # argsort-by-row + three 16M-element permutation gathers.  Stability
    # is not needed — equal (row, col) triples are duplicates whose
    # values the compress pass sums regardless of order.
    rows, cols, vals = jax.lax.sort(
        (rows, cols, vals), num_keys=2, is_stable=False
    )

    prev_r = jnp.concatenate([rows[:1] - 1, rows[:-1]]) if n_pad else rows
    prev_c = jnp.concatenate([cols[:1] - 1, cols[:-1]]) if n_pad else cols
    new = ((rows != prev_r) | (cols != prev_c)) & (rows != _SENT)
    return rows, cols, vals, new


@functools.partial(jax.jit, static_argnames=("nnz_pad", "nrows_pad"))
def _compress(rows, cols, vals, new, nnz_valid, nnz_pad: int, nrows_pad: int):
    """Collapse duplicate coordinates into the output CSR arrays.

    ``nnz_pad``/``nrows_pad`` (static) bucket the output; entries past
    ``nnz_valid`` (traced) are garbage and rowptr slots past the true row
    count are constant — the caller slices both off."""
    seg = jnp.cumsum(new.astype(big_int())) - 1
    out_vals = jax.ops.segment_sum(
        vals, seg, num_segments=max(nnz_pad, 1), indices_are_sorted=True
    )
    first = jnp.nonzero(new, size=nnz_pad, fill_value=0)[0]
    out_cols = cols[first].astype(COLIND_DTYPE)
    j = jnp.arange(nnz_pad)
    out_rows = jnp.where(j < nnz_valid, rows[first], nrows_pad)
    counts = jnp.bincount(
        out_rows, length=nrows_pad + 1
    )[:nrows_pad].astype(big_int())
    rps = jnp.zeros(nrows_pad + 1, dtype=big_int())
    rps = rps.at[1:].set(jnp.cumsum(counts))
    return rps, out_cols, out_vals[:nnz_pad]


def _esc_rows(a_vals, a_rps, a_cols, b_rps, b_cols, b_vals,
              nrows: int, ncols_out: int, out_dtype):
    """ESC product of one row chunk of A with all of B.  Host-syncs the
    expansion size and the output nnz (both data-dependent)."""
    from csr_tpu import CSR

    nnz_a = int(a_cols.shape[0])
    if nnz_a == 0:
        rps = jnp.zeros(nrows + 1, dtype=big_int())
        return CSR(nrows, ncols_out, 0, rps,
                   jnp.zeros(0, COLIND_DTYPE), jnp.zeros(0, out_dtype))
    b_row_nnz = jnp.diff(b_rps)
    ex = b_row_nnz[a_cols].astype(big_int())
    ex_cum = jnp.cumsum(ex)
    n_expand = int(ex_cum[-1])
    if n_expand == 0:
        rps = jnp.zeros(nrows + 1, dtype=big_int())
        return CSR(nrows, ncols_out, 0, rps,
                   jnp.zeros(0, COLIND_DTYPE), jnp.zeros(0, out_dtype))

    a_rids = structure._row_ids(a_rps, nrows, nnz_a)
    # bucket the chunk's A arrays too: chunk nnz is data-dependent and
    # would otherwise key a fresh compile per chunk shape
    nnz_a_pad = _bucket(nnz_a, floor=1024)
    if nnz_a_pad > nnz_a:
        pad = nnz_a_pad - nnz_a
        a_vals = jnp.pad(a_vals, (0, pad))
        a_cols = jnp.pad(a_cols, (0, pad))
        a_rids = jnp.pad(a_rids, (0, pad))
        ex_cum = jnp.pad(ex_cum, (0, pad), mode="edge")
    rows, cols, vals, new = _expand(
        a_vals, a_cols, a_rids, b_rps, b_cols, b_vals, ex_cum,
        jnp.asarray(n_expand, ex_cum.dtype), _bucket(n_expand), out_dtype,
    )
    nnz_out = int(jnp.sum(new))
    nrows_pad = _bucket(nrows, floor=1024)
    rps, out_cols, out_vals = _compress(
        rows, cols, vals, new, nnz_out, _bucket(nnz_out, floor=1024),
        nrows_pad,
    )
    return CSR(nrows, ncols_out, nnz_out, rps[: nrows + 1],
               out_cols[:nnz_out], out_vals[:nnz_out], _cast=False)


def _chunk_splits(a_rps_host: np.ndarray, b_row_nnz_host: np.ndarray,
                  a_cols_host: np.ndarray) -> list[int]:
    """Row split points keeping each chunk's expansion size under
    ``esc_chunk_entries`` (greedy, like reference csr/csr.py:599-621 but
    budgeting product terms instead of stored entries)."""
    nrows = len(a_rps_host) - 1
    per_entry = b_row_nnz_host[a_cols_host]
    per_row = np.zeros(nrows, dtype=np.int64)
    np.add.at(per_row, np.repeat(np.arange(nrows), np.diff(a_rps_host)), per_entry)
    cum = np.concatenate([[0], np.cumsum(per_row)])
    splits = [0]
    while splits[-1] < nrows:
        lo = splits[-1]
        hi = int(np.searchsorted(cum, cum[lo] + esc_chunk_entries, side="right")) - 1
        if hi <= lo:
            hi = lo + 1  # a single row exceeding the budget still advances
        splits.append(min(hi, nrows))
    return splits


def esc_mult_ab(a, b, out_dtype=None):
    """``C = A @ B`` for CSR ``a``, ``b`` without densifying anything.

    Matches the dense-routing path's semantics: entries sorted
    (row, col), duplicates summed; explicit zeros that *result from
    summation* are kept (the caller's ``_filter_zeros`` drops them, the
    same division of labor as reference csr/csr.py:553-556).
    """
    from csr_tpu import CSR

    assert a.ncols == b.nrows
    a_vals = a._required_values()
    b_vals = b._required_values()
    if out_dtype is None:
        out_dtype = jnp.promote_types(
            jnp.promote_types(a_vals.dtype, b_vals.dtype), jnp.float32
        )

    # chunk on host metadata so no chunk expands past the budget
    a_rps_h = np.asarray(a.rowptrs)
    b_nnz_h = np.diff(np.asarray(b.rowptrs))
    splits = _chunk_splits(a_rps_h, b_nnz_h, np.asarray(a.colinds))

    if len(splits) == 2:
        return _esc_rows(a_vals, a.rowptrs, a.colinds,
                         b.rowptrs, b.colinds, b_vals,
                         a.nrows, b.ncols, out_dtype)

    shards = []
    for lo, hi in zip(splits[:-1], splits[1:]):
        s0, s1 = int(a_rps_h[lo]), int(a_rps_h[hi])
        rps = a.rowptrs[lo : hi + 1] - int(a_rps_h[lo])
        shards.append(
            _esc_rows(a_vals[s0:s1], rps, a.colinds[s0:s1],
                      b.rowptrs, b.colinds, b_vals,
                      hi - lo, b.ncols, out_dtype)
        )
    return CSR._assemble_shards(shards)


def esc_mult_abt(a, b, out_dtype=None):
    """``C = A @ B^T`` via a transposed view of B (the reference's
    structural approach, csr/kernels/numba/multiply.py:41-57)."""
    from csr_tpu import CSR

    assert a.ncols == b.ncols
    t_rps, t_cis, t_vs = structure.transpose_arrays(
        b.rowptrs, b.colinds, b.values, b.nrows, b.ncols
    )
    bt = CSR(b.ncols, b.nrows, b.nnz, t_rps, t_cis, t_vs, _cast=False)
    return esc_mult_ab(a, bt, out_dtype)
