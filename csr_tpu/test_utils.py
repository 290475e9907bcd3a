"""
Hypothesis strategies for csr_tpu's property-based tests.

These generators target the same statistical envelope as the reference
suite — shapes up to 80x80, density up to 0.5, f4/f8 values, matrices
with and without stored values (behavioral envelope per reference
csr/test_utils.py; implementation is csr_tpu's own) — so that test
results stay comparable, while the machinery is organized around this
project's pipeline: pick a shape, scatter unique cells over the grid in
row-major order, attach FTZ-safe values, and construct through
:meth:`csr_tpu.CSR.from_coo`.

Deviations from the reference envelope:

* subnormal values are excluded globally — accelerator arithmetic may
  flush them to zero, so ``x != 0`` can disagree with a stored subnormal;
* f8 values are only drawn when ``jax_enable_x64`` is active, since
  without it every array silently narrows to f4.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sps

from hypothesis import HealthCheck, settings
import hypothesis.strategies as st
import hypothesis.extra.numpy as nph

from .csr import CSR
from .dtypes import x64_enabled

#: test-matrix size ceiling (rows and columns)
DIM_LIMIT = 80
#: test-matrix density ceiling
DENSITY_LIMIT = 0.5
#: value magnitude ceiling
VALUE_LIMIT = 1.0e3


def dims(limit: int = DIM_LIMIT):
    """A matrix-dimension strategy: small enough for dense oracles."""
    return st.integers(1, limit)


def value_dtypes():
    """Value dtypes honestly representable on the current x64 setting."""
    if x64_enabled():
        return st.sampled_from([np.dtype("f4"), np.dtype("f8")])
    return st.just(np.dtype("f4"))


def fractions(**kwargs):
    """Floats in [0, 1] (densities, probabilities)."""
    return st.floats(0, 1, **kwargs)


def _resolve(draw, spec, default):
    """Accept an int, a strategy, a sequence of choices, or None."""
    if spec is None:
        return draw(default)
    if isinstance(spec, st.SearchStrategy):
        return draw(spec)
    if isinstance(spec, (list, tuple)):
        return draw(st.sampled_from(list(spec)))
    return spec


@st.composite
def finite_arrays(draw, shape, dtype=np.float64(), min_value=-VALUE_LIMIT,
                  max_value=VALUE_LIMIT, **kwargs):
    """Finite-valued arrays of the given shape, NaN/inf-free."""
    dtype = np.dtype(dtype)
    elements = nph.from_dtype(
        dtype, min_value=min_value, max_value=max_value,
        allow_infinity=False, allow_nan=False, **kwargs,
    )
    return draw(nph.arrays(dtype, shape, elements=elements))


@st.composite
def grid_cells(draw, nrows: int, ncols: int, count: int):
    """``count`` distinct (row, col) coordinates on an nrows x ncols grid.

    Cells are drawn as a set of row-major linear ids and decoded, which
    gives uniform placement and shrinks toward the top-left corner."""
    ids = draw(
        st.sets(st.integers(0, nrows * ncols - 1),
                min_size=count, max_size=count)
    )
    linear = np.fromiter(ids, dtype=np.int64, count=count)
    return (
        (linear // ncols).astype(np.int32),
        (linear % ncols).astype(np.int32),
    )


@st.composite
def csrs(draw, nrows=None, ncols=None, nnz=None, max_nnz=None,
         max_density=DENSITY_LIMIT, values=None, dtype=None):
    """Draw a device CSR matrix.

    Every argument accepts a fixed value, a strategy, or None for the
    default envelope.  ``values=None`` draws matrices with and without
    stored values (structure-only = implicit ones)."""
    nrows = _resolve(draw, nrows, dims())
    ncols = _resolve(draw, ncols, dims())

    cap = int(np.ceil(nrows * ncols * max_density))
    if max_nnz is not None:
        cap = min(cap, max_nnz)
    nnz = _resolve(draw, nnz, st.integers(0, cap))
    nnz = min(nnz, nrows * ncols)

    rows, cols = draw(grid_cells(nrows, ncols, nnz)) if nnz else (
        np.zeros(0, np.int32), np.zeros(0, np.int32)
    )

    if values is None:
        values = draw(st.booleans())
    vals = None
    if values:
        vdtype = _resolve(draw, dtype, value_dtypes())
        vals = draw(finite_arrays(nnz, dtype=vdtype, allow_subnormal=False))
        keep = vals != 0.0  # from_coo stores explicit zeros; exclude here
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    return CSR.from_coo(rows, cols, vals, (nrows, ncols))


@st.composite
def mm_pairs(draw, max_shape=(100, 100, 100), dtype=None, **kwargs):
    """A conformable (A, B) pair for multiply tests: A is r x m, B is
    m x c, both with stored values of one shared dtype."""
    mr, mm, mc = max_shape
    r = draw(dims(mr))
    m = draw(dims(mm))
    c = draw(dims(mc))
    if dtype is None:
        dtype = np.float64() if x64_enabled() else np.float32()
    kwargs.setdefault("values", True)
    return (
        draw(csrs(r, m, dtype=dtype, **kwargs)),
        draw(csrs(m, c, dtype=dtype, **kwargs)),
    )


@st.composite
def sparse_matrices(draw, max_shape=(1000, 1000), density=None, format="csr"):
    """scipy.sparse matrices, for host-interop tests."""
    r = draw(dims(max_shape[0]))
    c = draw(dims(max_shape[1]))
    d = draw(fractions() if density is None else density)
    return sps.random(r, c, d, format=format)


def matrices(max_shape=(100, 100), dtype="f8"):
    """Dense numpy matrices."""
    shape = st.tuples(dims(max_shape[0]), dims(max_shape[1]))
    return nph.arrays(dtype, shape)


def csr_slow(divider: int = 2):
    """Settings for slow property tests: halved example count, no
    deadline, health checks off (layout builds and kernel compiles have
    high variance)."""
    base = settings.default
    return settings(
        base,
        deadline=None,
        suppress_health_check=list(HealthCheck),
        max_examples=max(base.max_examples // divider, 1),
    )


def has_memory(req_gb: float = 32) -> bool:
    """Gate for tests needing ``req_gb`` GiB of host RAM."""
    total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total >= req_gb * 1024**3
