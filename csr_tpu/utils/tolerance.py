"""
Error bounds for comparing a device result with a float64 host reference.

Sparse sums run in another order on every backend, and on a GPU XLA may
lower them to atomic adds whose order changes from run to run.  So the
bound on one output entry scales with the magnitudes summed into it, not
with the result:

    |out - ref| <= rtol * |ref| + 32 * eps * (|A| @ |x|)

with ``rtol`` 1e-4 for float32 and 1e-10 for float64, and ``eps`` the
machine epsilon of the computed dtype.  For SpMM and SpGEMM ``|A| @ |B|``
takes the place of ``|A| @ |x|``.  No matrix product runs on the tensor
cores, so TF32 rounding does not arise.
"""

from __future__ import annotations

import numpy as np

RTOL = {np.dtype(np.float32): 1e-4, np.dtype(np.float64): 1e-10}
EPS_MULT = 32


def bound(ref, abs_ref, dtype):
    """Per-entry tolerance for a result computed in ``dtype``."""
    dtype = np.dtype(dtype)
    ref = np.asarray(ref, np.float64)
    abs_ref = np.asarray(abs_ref, np.float64)
    return RTOL[dtype] * np.abs(ref) + EPS_MULT * np.finfo(dtype).eps * abs_ref


def check(out, ref, abs_ref, dtype, what: str = "result") -> tuple[float, float]:
    """Compare ``out`` with ``ref`` entry by entry under :func:`bound`.

    Returns the largest error and the tolerance of that entry; raises
    ``AssertionError`` naming the worst entries on a mismatch."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    if out.shape != ref.shape:
        raise AssertionError(f"{what}: shape {out.shape} != {ref.shape}")
    tol = bound(ref, abs_ref, dtype)
    err = np.abs(out - ref)
    bad = ~(err <= tol)  # NaN counts as a mismatch
    if np.any(bad):
        idx = np.argwhere(bad)[:5]
        raise AssertionError(
            f"{what}: {int(bad.sum())} entries out of bound; first at "
            f"{idx.tolist()}: err={err[bad][:5]} tol={tol[bad][:5]}"
        )
    if err.size == 0:
        return 0.0, 0.0
    at = np.unravel_index(np.argmax(err), err.shape)
    return float(err[at]), float(tol[at])


def _keys(m):
    """Row-major linear index of every stored entry of a canonical CSR."""
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int64), np.diff(m.indptr))
    return rows * m.shape[1] + m.indices


def check_sparse(out, ref, abs_ref, dtype, what: str = "product"):
    """Compare two scipy sparse matrices: ``out`` (canonical: row-sorted,
    no duplicates, no stored zeros) against ``ref`` after summing its
    duplicates and dropping its zeros, with ``abs_ref`` the sparse
    ``|A| @ |B|`` of the bound.

    The structures must agree, except where a sum cancels to exactly zero
    in ``dtype`` but not in float64 (or the other way round): zero-filtering
    then drops the entry from one side only.  Such an entry is compared as
    a zero and must lie within the bound like any other.  Returns
    ``(largest error, its tolerance, number of entries stored on one side
    only)``."""
    ref = ref.tocsr().astype(np.float64)
    ref.sum_duplicates()
    ref.eliminate_zeros()
    out = out.tocsr()
    if out.shape != ref.shape:
        raise AssertionError(f"{what}: shape {out.shape} != {ref.shape}")
    abs_ref = abs_ref.tocsr().astype(np.float64)
    abs_ref.sum_duplicates()
    ko, kr, ka = _keys(out), _keys(ref), _keys(abs_ref)
    if np.any(np.diff(ko) <= 0):
        raise AssertionError(f"{what}: entries unsorted or duplicated")
    union = np.union1d(ko, kr)
    got = np.zeros(len(union))
    got[np.searchsorted(union, ko)] = out.data
    want = np.zeros(len(union))
    want[np.searchsorted(union, kr)] = ref.data
    pos = np.searchsorted(ka, union)
    found = pos < len(ka)
    found[found] = ka[pos[found]] == union[found]
    mass = np.zeros(len(union))
    mass[found] = abs_ref.data[pos[found]]
    err, tol = check(got, want, mass, dtype, what)
    return err, tol, 2 * len(union) - len(ko) - len(kr)
