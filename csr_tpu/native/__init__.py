"""
ctypes bindings for the native host CSR utilities.

The native library is the framework's C++ component (the role of the
reference's cffi-built MKL shim, reference: tasks.py:24-55 +
csr/kernels/mkl/_api.py): it accelerates host-side construction paths that
run on numpy buffers before data ships to the device.  The library is built
on demand with g++ (see :mod:`csr_tpu.native.build`) and cached next to
this file; every caller has a pure-Python/XLA fallback, so a missing
toolchain only costs speed.
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

_log = logging.getLogger(__name__)

_LIB = None
_TRIED = False


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _fp(a):
    t = ctypes.c_double if a.dtype == np.float64 else ctypes.c_float
    return a.ctypes.data_as(ctypes.POINTER(t))


def get_lib():
    """The loaded native library, or None when unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("CSR_TPU_NO_NATIVE"):
        return None
    try:
        from .build import ensure_built

        path = ensure_built()
        lib = ctypes.CDLL(path)
        for name in ("csrt_filter_zeros_f64", "csrt_filter_zeros_f32"):
            getattr(lib, name).restype = ctypes.c_int64
        _LIB = lib
    except Exception as e:  # missing toolchain, sandboxed build, ...
        _log.debug("native csr host library unavailable: %s", e)
        _LIB = None
    return _LIB


def available() -> bool:
    return get_lib() is not None


def from_coo(nrows: int, rows, cols, values=None):
    """Native COO->CSR; returns (rowptrs i64, colinds i32, values) numpy
    arrays, or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    nnz = len(rows)
    rowptrs = np.empty(nrows + 1, np.int64)
    out_cols = np.empty(nnz, np.int32)
    if values is None:
        lib.csrt_from_coo_structure(
            nnz, _i32p(rows), _i32p(cols), nrows, _i64p(rowptrs), _i32p(out_cols)
        )
        return rowptrs, out_cols, None
    values = np.ascontiguousarray(values)
    if values.dtype == np.float64:
        fn = lib.csrt_from_coo_f64
    elif values.dtype == np.float32:
        fn = lib.csrt_from_coo_f32
    else:
        return None
    out_vals = np.empty(nnz, values.dtype)
    fn(
        nnz, _i32p(rows), _i32p(cols), _fp(values), nrows,
        _i64p(rowptrs), _i32p(out_cols), _fp(out_vals),
    )
    return rowptrs, out_cols, out_vals


def transpose(nrows, ncols, rowptrs, colinds, values=None):
    """Native CSR transpose on host arrays, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rowptrs = np.ascontiguousarray(rowptrs, np.int64)
    colinds = np.ascontiguousarray(colinds, np.int32)
    nnz = len(colinds)
    t_rps = np.empty(ncols + 1, np.int64)
    t_cis = np.empty(nnz, np.int32)
    if values is None:
        lib.csrt_transpose_structure(
            nrows, ncols, _i64p(rowptrs), _i32p(colinds), _i64p(t_rps), _i32p(t_cis)
        )
        return t_rps, t_cis, None
    values = np.ascontiguousarray(values)
    if values.dtype == np.float64:
        fn = lib.csrt_transpose_f64
    elif values.dtype == np.float32:
        fn = lib.csrt_transpose_f32
    else:
        return None
    t_vls = np.empty(nnz, values.dtype)
    fn(
        nrows, ncols, _i64p(rowptrs), _i32p(colinds), _fp(values),
        _i64p(t_rps), _i32p(t_cis), _fp(t_vls),
    )
    return t_rps, t_cis, t_vls


def sort_rows(nrows, rowptrs, colinds, values=None):
    """Native in-place per-row column sort; mutates colinds/values.
    Returns True on success."""
    lib = get_lib()
    if lib is None:
        return False
    rowptrs = np.ascontiguousarray(rowptrs, np.int64)
    assert colinds.dtype == np.int32 and colinds.flags.c_contiguous
    if values is None:
        lib.csrt_sort_rows_structure(nrows, _i64p(rowptrs), _i32p(colinds))
        return True
    if values.dtype == np.float64:
        lib.csrt_sort_rows_f64(nrows, _i64p(rowptrs), _i32p(colinds), _fp(values))
    elif values.dtype == np.float32:
        lib.csrt_sort_rows_f32(nrows, _i64p(rowptrs), _i32p(colinds), _fp(values))
    else:
        return False
    return True
