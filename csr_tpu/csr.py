"""
Device-resident compressed sparse row matrices.

``CSR`` mirrors the public API of the reference implementation
(reference: csr/csr.py:46-692) but is built for JAX:

* the three data arrays (``rowptrs``, ``colinds``, ``values``) are
  device-resident ``jax.Array``s;
* ``CSR`` is a registered JAX pytree, so it can be passed through
  ``jax.jit`` / ``jax.vmap`` / ``shard_map`` boundaries.  This replaces the
  reference's dual Python/Numba "structref" identity
  (reference: csr/csr.py:20-43, csr/_wiring.py);
* shape metadata (``nrows``, ``ncols``, ``nnz``) is static Python data, so
  every operation traces with static shapes as XLA requires;
* compute is dispatched through the pluggable kernel API
  (see :mod:`csr_tpu.kernels`), with a pure-XLA backend and a SciPy host
  oracle.

The value array is optional: a matrix can store structure only, in which
case every stored entry has implicit value 1.0
(reference: csr/csr.py:244-262).
"""

from __future__ import annotations

import logging
import warnings

import numpy as np
import jax
import jax.numpy as jnp

from . import _rows, dtypes, structure
from .dtypes import COLIND_DTYPE, INT32_MAX, ptr_dtype
from .kernels import get_kernel, releasing

_log = logging.getLogger(__name__)

__all__ = ["CSR"]


def _as_index_array(x, dtype):
    if x is None:
        return None
    np_dtype = np.dtype(dtype.dtype if hasattr(dtype, "dtype") else dtype)
    # int64 indices (rowptrs past INT32_MAX entries) must not silently
    # narrow when jax_enable_x64 is off
    with dtypes.x64_scope(np_dtype.itemsize >= 8):
        if isinstance(x, jax.Array):
            return x.astype(dtype) if x.dtype != dtype else x
        return jnp.asarray(np.require(np.asarray(x), np_dtype, "C"))


class CSR:
    """
    Simple compressed sparse row matrix on a JAX device.

    This is like :class:`scipy.sparse.csr_matrix`, with a few useful
    differences (mirroring the reference, csr/csr.py:46-77):

    * The value array is optional, for cases in which only the matrix
      structure is required.
    * All arrays are JAX device arrays; operations execute on the
      configured backend ("kernel"), by default ``xla``.
    * Instances are JAX pytrees and can cross ``jit`` boundaries.

    Attributes:
        nrows(int): the number of rows.
        ncols(int): the number of columns.
        nnz(int): the number of stored entries.
        rowptrs(jax.Array): the row pointers, shape ``(nrows + 1,)``.
        colinds(jax.Array): the column indices, shape ``(nnz,)``.
        values(jax.Array or None): the values, shape ``(nnz,)``.
    """

    __slots__ = ("nrows", "ncols", "rowptrs", "colinds", "_values",
                 "_shard_cache")

    def __init__(self, nrows, ncols, nnz, rps, cis, vs, _cast=True):
        assert nrows >= 0
        assert nrows <= INT32_MAX
        assert ncols >= 0
        assert ncols <= INT32_MAX
        assert nnz >= 0
        self.nrows = int(nrows)
        self.ncols = int(ncols)

        if _cast:
            cis = _as_index_array(cis, COLIND_DTYPE)
            rps = _as_index_array(rps, ptr_dtype(nnz))
            if vs is not None:
                if not isinstance(vs, jax.Array):
                    vs = np.asarray(vs)
                    if vs.dtype == np.float64 and not dtypes.x64_enabled():
                        # f64 host data narrows to f32 unless
                        # jax_enable_x64 is set (see csr_tpu.dtypes)
                        vs = vs.astype(np.float32)
                vs = jnp.asarray(vs)
        else:
            rps = jnp.asarray(rps)
            cis = jnp.asarray(cis)
            vs = None if vs is None else jnp.asarray(vs)

        assert rps.shape == (self.nrows + 1,), (rps.shape, self.nrows)
        assert cis.shape[0] == nnz
        self.rowptrs = rps
        self.colinds = cis
        self._values = vs

    # -- shape / data properties -------------------------------------------

    @property
    def nnz(self) -> int:
        return int(self.colinds.shape[0])

    @property
    def values(self):
        return self._values

    @values.setter
    def values(self, vs):
        # reference semantics: csr/csr.py:225-242
        if vs is None:
            self._values = None
            return
        vs = jnp.asarray(vs)
        if vs.shape[0] < self.nnz:
            raise ValueError("value array too small")
        elif vs.shape[0] > self.nnz:
            vs = vs[: self.nnz]
        self._values = vs

    # -- constructors ------------------------------------------------------

    @classmethod
    def empty(cls, nrows, ncols, row_nnzs=None, values=True):
        """
        Create a zero-filled CSR matrix (reference: csr/csr.py:102-137).

        Args:
            nrows(int): the number of rows.
            ncols(int): the number of columns.
            row_nnzs(array-like):
                the number of stored entries for each row, or None for an
                empty matrix.
            values(bool or numpy.dtype):
                whether it has values or only structure; can be a dtype to
                specify a type other than the default float.
        """
        assert nrows >= 0
        assert ncols >= 0
        if row_nnzs is None:
            rps = jnp.zeros(nrows + 1, dtype=jnp.int32)
            cis = jnp.zeros(0, dtype=COLIND_DTYPE)
            vs = jnp.zeros(0, dtype=dtypes.default_value_dtype()) if values is True else (
                jnp.zeros(0, dtype=values) if values else None
            )
            return cls(nrows, ncols, 0, rps, cis, vs)

        row_nnzs = np.asarray(row_nnzs)
        assert len(row_nnzs) == nrows
        nnz = int(np.sum(row_nnzs, dtype=np.int64))
        assert nnz >= 0
        rps = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(row_nnzs, dtype=np.int64, out=rps[1:])
        cis = jnp.zeros(nnz, dtype=COLIND_DTYPE)
        if values is True:
            vs = jnp.zeros(nnz, dtype=dtypes.default_value_dtype())
        elif values:
            vs = jnp.zeros(nnz, dtype=values)
        else:
            vs = None
        return cls(nrows, ncols, nnz, rps, cis, vs)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape=None, *, rpdtype=None):
        """
        Create a CSR matrix from data in COO format
        (reference: csr/csr.py:139-169).

        Entries keep their input order within each row (the conversion is a
        stable sort by row, matching the reference's counting scatter).

        Args:
            rows(array-like): the row indices.
            cols(array-like): the column indices.
            vals(array-like): the data values; can be ``None``.
            shape(tuple): the array shape, or ``None`` to infer it.
            rpdtype(numpy.dtype):
                row-pointer integer dtype, or ``None`` for the automatic
                policy (int32, widened past INT32_MAX entries).  The
                reference accepts this argument but never reads it
                (reference: csr/csr.py:140 — signature only); here it is
                honored, with a capacity check against ``nnz``.
        """
        rows = np.asarray(rows) if not isinstance(rows, jax.Array) else rows
        cols = np.asarray(cols) if not isinstance(cols, jax.Array) else cols

        nnz = int(len(rows))
        assert len(cols) == nnz
        assert vals is None or len(vals) == nnz

        traced = isinstance(rows, jax.core.Tracer) or isinstance(
            cols, jax.core.Tracer
        )
        if traced:
            # under jit the data is abstract: bounds cannot be validated on
            # the host, and the shape cannot be inferred from the data
            if shape is None:
                raise ValueError(
                    "CSR.from_coo requires an explicit shape= when traced"
                )
            nrows, ncols = shape
            rps, cis, vs = structure.from_coo(nrows, rows, cols, vals)
            return cls._with_rpdtype(
                cls(nrows, ncols, nnz, rps, cis, vs), rpdtype
            )

        if nnz:
            rmin = int(jnp.min(jnp.asarray(rows))) if isinstance(rows, jax.Array) else int(np.min(rows))
            cmin = int(jnp.min(jnp.asarray(cols))) if isinstance(cols, jax.Array) else int(np.min(cols))
            assert rmin >= 0
            assert cmin >= 0
            rmax = int(jnp.max(jnp.asarray(rows))) if isinstance(rows, jax.Array) else int(np.max(rows))
            cmax = int(jnp.max(jnp.asarray(cols))) if isinstance(cols, jax.Array) else int(np.max(cols))
        else:
            rmax = cmax = -1

        if shape is not None:
            nrows, ncols = shape
            assert rmax < max(nrows, 1)
            assert cmax < max(ncols, 1)
        else:
            nrows = rmax + 1
            ncols = cmax + 1

        rps, cis, vs = structure.from_coo(nrows, rows, cols, vals)
        return cls._with_rpdtype(cls(nrows, ncols, nnz, rps, cis, vs), rpdtype)

    @staticmethod
    def _with_rpdtype(csr, rpdtype):
        """Apply an explicit row-pointer dtype request to a fresh matrix.

        int64 requests are honored even without ``jax_enable_x64``
        (an x64 scope guards the conversion from silent narrowing)."""
        if rpdtype is None:
            return csr
        rpdtype = np.dtype(rpdtype)
        if csr.nnz > np.iinfo(rpdtype).max:
            raise ValueError(
                f"rpdtype {rpdtype} cannot address {csr.nnz} entries"
            )
        if csr.rowptrs.dtype != rpdtype:
            with dtypes.x64_scope(rpdtype.itemsize >= 8):
                csr.rowptrs = csr.rowptrs.astype(rpdtype)
        return csr

    @classmethod
    def from_scipy(cls, mat, copy=True):
        """
        Convert a scipy sparse matrix to a device CSR
        (reference: csr/csr.py:171-192).  Data is copied to the device, so
        ``copy`` is accepted for API compatibility but has no effect.
        """
        import scipy.sparse as sps

        if not sps.issparse(mat):
            raise TypeError("not a scipy sparse matrix")
        if mat.format != "csr":
            mat = mat.tocsr(copy=copy)
        return cls(mat.shape[0], mat.shape[1], mat.nnz, mat.indptr, mat.indices, mat.data)

    def to_scipy(self):
        """
        Convert to a :class:`scipy.sparse.csr_matrix` on the host
        (reference: csr/csr.py:194-209).
        """
        import scipy.sparse as sps

        values = self.values
        if values is None:
            values = np.full(self.nnz, 1.0)
        else:
            values = np.asarray(values)
        return sps.csr_matrix(
            (values, np.asarray(self.colinds), np.asarray(self.rowptrs)),
            shape=(self.nrows, self.ncols),
        )

    @classmethod
    def from_bcoo(cls, mat):
        """Convert a ``jax.experimental.sparse.BCOO`` matrix (JAX's native
        sparse format) to a device CSR.

        The JAX-side analog of the reference's scipy interop
        (reference: csr/csr.py:171-192): duplicate coordinates must already
        be summed (``mat.sum_duplicates()``)."""
        assert mat.ndim == 2, "only 2-D BCOO supported"
        # batch/dense dimensions change the indices layout: a BCOO with
        # n_batch/n_dense > 0 is still 2-D but indices[:, 0/1] would misparse
        assert mat.n_batch == 0 and mat.n_dense == 0, (
            "only unbatched, fully-sparse BCOO supported"
        )
        rows = np.asarray(mat.indices[:, 0])
        cols = np.asarray(mat.indices[:, 1])
        return cls.from_coo(rows, cols, np.asarray(mat.data), shape=mat.shape)

    def to_bcoo(self):
        """Convert to a ``jax.experimental.sparse.BCOO`` matrix.

        Indices come out in row-major order (rows ascend), but CSR permits
        unsorted in-row columns and duplicate coordinates, and BCOO's
        sortedness/uniqueness flags are unverified promises whose violation
        is undefined behavior — so they are left False.  Call
        ``sort_rows()`` and ``bcoo.sum_duplicates()`` when a downstream op
        needs them set."""
        from jax.experimental import sparse as jsparse

        indices = jnp.stack(
            [jnp.asarray(self.rowinds(), dtype=jnp.int32),
             self.colinds.astype(jnp.int32)],
            axis=1,
        )
        return jsparse.BCOO(
            (self._required_values(), indices),
            shape=(self.nrows, self.ncols),
            indices_sorted=False,
            unique_indices=False,
        )

    # -- implicit-value helpers -------------------------------------------

    def _required_values(self):
        """Value array, or implicit ones for structure-only matrices
        (reference: csr/csr.py:244-252)."""
        vs = self.values
        if vs is None:
            return jnp.ones(self.nnz, dtype=dtypes.default_value_dtype())
        return vs

    def _e_value(self, i):
        """Value of entry ``i``, 1.0 if structure-only
        (reference: csr/csr.py:254-262)."""
        vs = self.values
        if vs is not None:
            return vs[i]
        return 1.0

    def _normalize(self, val_dtype=np.float64, ptr_dtype_=None, *, ptr_dtype=None):
        """
        Normalize into a predictable structure and dtype
        (reference: csr/csr.py:264-299).
        """
        if ptr_dtype is None:
            ptr_dtype = ptr_dtype_
        if ptr_dtype:
            np_ptr = np.dtype(ptr_dtype)
            if self.nnz > np.iinfo(np_ptr).max:
                raise ValueError(f"type {ptr_dtype} cannot address {self.nnz} entries")
            with dtypes.x64_scope(np_ptr.itemsize >= 8):
                rps = self.rowptrs.astype(ptr_dtype)
        else:
            rps = self.rowptrs

        if val_dtype:
            val_dtype = dtypes.canon_float(val_dtype)
            if self.values is None:
                vs = jnp.ones(self.nnz, val_dtype)
            else:
                vs = self.values.astype(val_dtype)
        elif val_dtype is False:
            vs = None
        else:
            vs = self.values

        return CSR(self.nrows, self.ncols, self.nnz, rps, self.colinds, vs, _cast=False)

    def copy(self, include_values=True, *, copy_structure=True):
        """
        Create a copy of this CSR (reference: csr/csr.py:301-321).

        JAX arrays are immutable, so sharing storage is always safe; the
        ``copy_structure`` flag is honored for API compatibility.
        """
        values = self.values
        if include_values and values is not None:
            values = jnp.copy(values) if copy_structure else values
        else:
            values = None
        rps, cis = self.rowptrs, self.colinds
        if copy_structure:
            rps = jnp.copy(rps)
            cis = jnp.copy(cis)
        return CSR(self.nrows, self.ncols, self.nnz, rps, cis, values)

    # -- structure ops -----------------------------------------------------

    def sort_rows(self):
        """Sort the rows of this matrix in column order. This is an
        **in-place operation** (reference: csr/csr.py:323-328)."""
        cis, vs = structure.sort_rows_arrays(
            self.rowptrs, self.colinds, self.values, self.nrows
        )
        self.colinds = cis
        self._values = vs

    def subset_rows(self, begin, end):
        """Subset the rows in this matrix (reference: csr/csr.py:330-345)."""
        rps, cis, vs, nnz = structure.subset_rows_arrays(self, begin, end)
        return CSR(end - begin, self.ncols, nnz, rps, cis, vs)

    def pick_rows(self, rows, *, include_values=True):
        """Pick (possibly repeated) rows from this matrix
        (reference: csr/csr.py:347-364)."""
        inc = include_values and self.values is not None
        rps, cis, vs, nnz = structure.pick_rows_arrays(self, rows, inc)
        return CSR(len(rows), self.ncols, nnz, rps, cis, vs)

    # -- row access --------------------------------------------------------

    def rowinds(self):
        """Row indices of every stored entry (COO row vector)
        (reference: csr/csr.py:366-371)."""
        return structure.row_ids_for(self)

    def row(self, row):
        """One or more rows as dense vectors (reference: csr/csr.py:373-387).

        Structure-only matrices densify to 1s at stored positions."""
        return _rows.row_array(self, row)

    def row_mask(self, row):
        """Dense boolean mask of stored columns for one or more rows
        (reference: csr/csr.py:389-404)."""
        return _rows.row_mask(self, row)

    def row_extent(self, row):
        """(start, end) extent of a row in the data arrays
        (reference: csr/csr.py:406-417)."""
        return _rows.extent(self, row)

    def row_cs(self, row):
        """Column indices of a row's stored entries
        (reference: csr/csr.py:419-423)."""
        return _rows.cs(self, row)

    def row_vs(self, row):
        """Stored values of a row; 1s if structure-only
        (reference: csr/csr.py:425-430)."""
        return _rows.vs(self, row)

    def row_nnzs(self):
        """Number of stored entries per row (reference: csr/csr.py:432-441)."""
        return jnp.diff(self.rowptrs)

    # -- transforms --------------------------------------------------------

    def normalize_rows(self, normalization):
        """
        Normalize the rows of the matrix **in place**, returning the per-row
        statistic (reference: csr/csr.py:443-469).

        Args:
            normalization(str): ``'center'`` (subtract the row mean) or
                ``'unit'`` (scale to unit Euclidean norm).
        """
        from . import transform

        if self.values is None:
            # the reference fails with an untyped error here (its njit
            # transform reads csr.values.dtype); make the contract explicit
            raise ValueError("cannot normalize a structure-only matrix")
        if normalization == "center":
            vs, stats = transform.center_rows(self)
        elif normalization == "unit":
            vs, stats = transform.unit_rows(self)
        else:
            raise ValueError("unknown normalization: " + normalization)
        self._values = vs
        return stats

    def transpose(self, include_values=True):
        """Transpose this matrix (reference: csr/csr.py:471-486)."""
        vs = self.values if include_values else None
        t_rps, t_cis, t_vs = structure.transpose_arrays(
            self.rowptrs, self.colinds, vs, self.nrows, self.ncols
        )
        return CSR(self.ncols, self.nrows, self.nnz, t_rps, t_cis, t_vs)

    def transpose_structure(self):
        """Structure-only transpose (reference: csr/csr.py:488-492)."""
        return self.transpose(False)

    def filter_nnzs(self, filt):
        """Filter stored entries by a boolean mask along the nnz axis
        (reference: csr/csr.py:494-522)."""
        filt = np.asarray(filt) if not isinstance(filt, jax.Array) else filt
        if filt.shape[0] != self.nnz:
            raise ValueError(
                "filter has length %d, expected %d" % (filt.shape[0], self.nnz)
            )
        rps, cis, vs, nnz = structure.filter_nnzs_arrays(self, filt)
        return CSR(self.nrows, self.ncols, nnz, rps, cis, vs)

    # -- multiplication ----------------------------------------------------

    def multiply(self, other, transpose=False):
        """
        Multiply this matrix by another sparse matrix
        (reference: csr/csr.py:524-567).

        Args:
            other(CSR): the other matrix.
            transpose(bool): if ``True``, compute :math:`AB^{T}`.

        Returns:
            CSR: the product, with explicit zeros filtered out.
        """
        if transpose:
            assert self.ncols == other.ncols
        else:
            assert self.ncols == other.nrows

        K = get_kernel()

        def mul(A, b_h):
            with releasing(K.to_handle(A), K) as a_h:
                if transpose:
                    c_h = K.mult_abt(a_h, b_h)
                else:
                    c_h = K.mult_ab(a_h, b_h)
                with releasing(c_h, K):
                    crepr = K.from_handle(c_h)
            crepr._filter_zeros()
            return crepr

        if self.nnz <= K.max_nnz:
            with releasing(K.to_handle(other), K) as b_h:
                return mul(self, b_h)
        else:
            shards = self._shard_rows(K.max_nnz)
            with releasing(K.to_handle(other), K) as b_h:
                sparts = [mul(s, b_h) for s in shards]
            return CSR._assemble_shards(sparts)

    def mult_vec(self, v):
        """
        Multiply this matrix by a dense vector (SpMV)
        (reference: csr/csr.py:569-590).

        Args:
            v(array-like): a vector of length ``ncols``.

        Returns:
            jax.Array: :math:`A\\vec{x}`.
        """
        v = jnp.asarray(v)
        assert v.shape == (self.ncols,)
        K = get_kernel()
        if self.nnz <= K.max_nnz:
            with releasing(K.to_handle(self), K) as h:
                return K.mult_vec(h, v)
        else:
            shards = self._shard_rows(K.max_nnz)
            svs = []
            for s in shards:
                with releasing(K.to_handle(s), K) as h:
                    svs.append(K.mult_vec(h, v))
            return jnp.concatenate(svs)

    def mult_vec_t(self, v):
        """
        Multiply the transpose of this matrix by a dense vector:
        :math:`A^{T}\\vec{v}`.

        An extension of the reference API, which reaches the same product
        via ``transpose().mult_vec(v)``
        (reference: csr/kernels/numba/multiply.py:41-57); here it is one
        kernel call with no transposed copy of the matrix.

        Args:
            v(array-like): a vector of length ``nrows``.

        Returns:
            jax.Array: :math:`A^{T}\\vec{v}`, length ``ncols``.
        """
        v = jnp.asarray(v)
        assert v.shape == (self.nrows,)
        K = get_kernel()
        if self.nnz <= K.max_nnz:
            with releasing(K.to_handle(self), K) as h:
                return K.mult_vec_t(h, v)
        # capacity path: row shards contribute partial column-space sums
        shards = self._shard_rows(K.max_nnz)
        out = None
        off = 0
        for s in shards:
            with releasing(K.to_handle(s), K) as h:
                part = K.mult_vec_t(h, v[off : off + s.nrows])
            out = part if out is None else out + part
            off += s.nrows
        return out

    def mult_dense(self, b):
        """
        Multiply this matrix by a dense matrix (SpMM): ``A @ B``.

        An extension of the reference API, which only exposes SpMV and
        sparse-sparse products.

        Args:
            b(array-like): a dense matrix of shape ``(ncols, n)``.

        Returns:
            jax.Array: the dense product, shape ``(nrows, n)``.
        """
        b = jnp.asarray(b)
        assert b.ndim == 2 and b.shape[0] == self.ncols
        K = get_kernel()
        if self.nnz <= K.max_nnz:
            with releasing(K.to_handle(self), K) as h:
                return K.mult_dense(h, b)
        shards = self._shard_rows(K.max_nnz)
        outs = []
        for s in shards:
            with releasing(K.to_handle(s), K) as h:
                outs.append(K.mult_dense(h, b))
        return jnp.concatenate(outs, axis=0)

    # -- internal helpers --------------------------------------------------

    def _filter_zeros(self):
        """Drop explicitly stored zero values **in place**
        (reference: csr/csr.py:592-597, csr/_struct.py:61-79)."""
        if self.values is None:
            return
        rps, cis, vs, nnz = structure.filter_nnzs_arrays(self, self.values != 0)
        self.rowptrs = rps
        self.colinds = cis
        self._values = vs

    def _shard_rows(self, tgt_nnz):
        """Shard by rows so each shard has at most ``tgt_nnz`` stored
        entries (reference: csr/csr.py:599-621).  This is the single-device
        ancestor of the mesh row partitioner in
        :mod:`csr_tpu.parallel.partition`.

        The shard list is cached on this matrix (identity-keyed on the
        three buffers + the target), so repeated over-capacity multiplies
        reuse the same shard objects instead of slicing the matrix again
        (the reference reuses B's handle across shards in the same
        spirit, reference: csr/csr.py:565)."""
        assert tgt_nnz > 0
        cached = getattr(self, "_shard_cache", None)
        if (
            cached is not None
            and cached[0] is self.rowptrs
            and cached[1] is self.colinds
            and cached[2] is self._values
            and cached[3] == tgt_nnz
        ):
            return cached[4]

        rowptrs_host = np.asarray(self.rowptrs)
        rest = self
        rest_off = 0
        shards = []
        while rest.nnz > tgt_nnz:
            rp = rowptrs_host[rest_off:] - rowptrs_host[rest_off]
            split = int(np.searchsorted(rp[: rest.nrows + 1], tgt_nnz, side="right")) - 1
            if rp[split] > tgt_nnz:
                split -= 1
            if split < 1:
                raise ValueError("row too large to fit in target matrix size")
            _log.debug("splitting %s at %d (rp@s: %d)", rest, split, rp[split])
            shards.append(rest.subset_rows(0, split))
            rest = rest.subset_rows(split, rest.nrows)
            rest_off += split

        shards.append(rest)
        self._shard_cache = (
            self.rowptrs, self.colinds, self._values, tgt_nnz, shards
        )
        return shards

    @classmethod
    def _assemble_shards(cls, shards):
        """Reassemble a matrix from row shards (reference: csr/csr.py:623-650)."""
        nrows, ncols, nnz, rps, cis, vs = structure.assemble_shards_arrays(shards)
        return cls(nrows, ncols, nnz, rps, cis, vs)

    # -- deprecated value ops ---------------------------------------------

    def drop_values(self):
        """Remove the value array **in place** (deprecated)
        (reference: csr/csr.py:652-661)."""
        warnings.warn("drop_values is deprecated", DeprecationWarning)
        self._values = None

    def fill_values(self, value):
        """Fill values with a constant **in place**, adding a value array to
        structure-only matrices (reference: csr/csr.py:663-675)."""
        if self.values is not None:
            self._values = jnp.full_like(self.values, value)
        else:
            self._values = jnp.full(self.nnz, value, dtype=dtypes.default_value_dtype())

    # -- dunder ------------------------------------------------------------

    def __str__(self):
        return "<CSR {}x{} ({} nnz)>".format(self.nrows, self.ncols, self.nnz)

    def __repr__(self):
        out = "<CSR {}x{} ({} nnz)".format(self.nrows, self.ncols, self.nnz)
        out += " {\n"
        out += "  rowptrs={}\n".format(np.asarray(self.rowptrs))
        out += "  colinds={}\n".format(np.asarray(self.colinds))
        out += "  values={}\n".format(None if self.values is None else np.asarray(self.values))
        out += "  dtype={}\n".format(self.values.dtype if self.values is not None else None)
        out += "}>"
        return out

    def __reduce__(self):
        # pickle via host arrays (reference: csr/csr.py:690-692)
        vs = None if self.values is None else np.asarray(self.values)
        args = (
            self.nrows,
            self.ncols,
            self.nnz,
            np.asarray(self.rowptrs),
            np.asarray(self.colinds),
            vs,
            True,
        )
        return (CSR, args)


# ---------------------------------------------------------------------------
# pytree registration — the JAX analog of the reference's Numba structref
# wiring (reference: csr/_wiring.py:14-17): it makes CSR a first-class citizen
# of jit/vmap/shard_map instead of nopython mode.


def _csr_flatten(c: CSR):
    return (c.rowptrs, c.colinds, c._values), (c.nrows, c.ncols)


def _csr_unflatten(aux, children):
    nrows, ncols = aux
    rps, cis, vs = children
    obj = object.__new__(CSR)
    obj.nrows = nrows
    obj.ncols = ncols
    obj.rowptrs = rps
    obj.colinds = cis
    obj._values = vs
    return obj


jax.tree_util.register_pytree_node(CSR, _csr_flatten, _csr_unflatten)
