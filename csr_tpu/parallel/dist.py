"""
Distributed sparse operations over a device mesh.

The reference is single-node (SURVEY §2: no distributed backend); its row
sharding exists only for kernel capacity.  Here row partitioning is a
first-class parallel axis: matrices are row-sharded over ``mesh['rows']``
(:mod:`csr_tpu.parallel.partition`), the dense operand is either
replicated or column-sharded, and the collectives are XLA's
(``all_gather`` / ``psum``) over the interconnect between devices.

Operations:

* ``spmv(dcsr, x)``      — ``y = A @ x``; x replicated or gathered, y row-sharded.
* ``spmv_t(dcsr, y)``    — ``x = A^T @ y``; y row-sharded, result psum-reduced.
* ``spmm(dcsr, B)``      — ``C = A @ B`` with dense B; C row-sharded.
* ``spmv_halo(dcsr, xs)``— x column-sharded; each device all-gathers the
                           halo slices it needs before local compute.

Local per-device compute is the same segment-sum formulation the ``xla``
kernel uses on one device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .partition import DistCSR


def _local_row_ids(rowptrs, nnz_per: int):
    """Row ids for one padded shard: boundary scatter + cumsum over the
    local rowptrs (searchsorted avoided — see structure._row_ids).
    Padded entries map to padded rows (whose output is sliced off):
    boundaries at ``nnz_per`` are dropped (no positions lie past them),
    while boundaries below ``nnz_per`` mark the padded positions up to
    the padded row id."""
    bnd = rowptrs[1:]
    ind = jnp.zeros(nnz_per, jnp.int32).at[
        jnp.clip(bnd, 0, nnz_per - 1)
    ].add(jnp.where(bnd < nnz_per, 1, 0).astype(jnp.int32))
    return jnp.cumsum(ind)


def _local_spmv(rowptrs, colinds, values, x, rows_per: int):
    """Dense-operand local SpMV on one shard (padded shapes)."""
    rids = _local_row_ids(rowptrs, colinds.shape[0])
    prod = values * x[colinds]
    return jax.ops.segment_sum(
        prod, rids, num_segments=rows_per + 1, indices_are_sorted=True
    )[:rows_per]


def spmv(dcsr: DistCSR, x, mesh: Mesh, axis: str = "rows"):
    """``y = A @ x`` with A row-sharded and x replicated.

    Returns y as a (D, rows_per_shard) row-sharded array; use
    :func:`collect_rows` for the dense global vector.
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P()),
        out_specs=P(axis, None),
        check_vma=False,
    )
    def _run(rps, cis, vls, xv):
        y = _local_spmv(rps[0], cis[0], vls[0], xv, dcsr.rows_per_shard)
        return y[None, :]

    return _run(dcsr.rowptrs, dcsr.colinds, dcsr.values, x.astype(dcsr.values.dtype))


def spmv_halo(dcsr: DistCSR, x_sharded, mesh: Mesh, axis: str = "rows"):
    """``y = A @ x`` with x *column-sharded* over the same mesh axis.

    Each device all-gathers the dense operand over the interconnect
    before local compute — the halo-exchange form for matrices whose
    dense operand is itself distributed (the generalization the
    reference's row sharding points at, SURVEY §5 long-axis analog).  XLA
    overlaps the gather with the leading compute where profitable.
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
        out_specs=P(axis, None),
        check_vma=False,
    )
    def _run(rps, cis, vls, x_part):
        xv = jax.lax.all_gather(x_part, axis, tiled=True)
        y = _local_spmv(rps[0], cis[0], vls[0], xv, dcsr.rows_per_shard)
        return y[None, :]

    return _run(dcsr.rowptrs, dcsr.colinds, dcsr.values, x_sharded)


def spmv_t(dcsr: DistCSR, y_sharded, mesh: Mesh, axis: str = "rows"):
    """``x = A^T @ y``: every device computes its shard's contribution to
    the full column space, then cross-device ``psum`` reduces.

    ``y_sharded`` is (D, rows_per_shard) row-sharded (e.g. the output of
    :func:`spmv`).  Result is the replicated dense vector of length ncols.
    """

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis, None)),
        out_specs=P(),
        check_vma=False,
    )
    def _run(rps, cis, vls, yv):
        rids = _local_row_ids(rps[0], cis.shape[1])
        yi = jnp.where(rids < dcsr.rows_per_shard, yv[0][jnp.minimum(rids, dcsr.rows_per_shard - 1)], 0)
        contrib = jnp.zeros(dcsr.ncols, vls.dtype).at[cis[0]].add(vls[0] * yi)
        return jax.lax.psum(contrib, axis)

    return _run(dcsr.rowptrs, dcsr.colinds, dcsr.values, y_sharded)


def spmm(dcsr: DistCSR, b_dense, mesh: Mesh, axis: str = "rows"):
    """``C = A @ B`` with dense B replicated; C row-sharded
    (D, rows_per_shard, B.ncols)."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(None, None)),
        out_specs=P(axis, None, None),
        check_vma=False,
    )
    def _run(rps, cis, vls, B):
        rids = _local_row_ids(rps[0], cis.shape[1])
        contrib = vls[0][:, None] * B[cis[0]]
        out = jax.ops.segment_sum(
            contrib, rids, num_segments=dcsr.rows_per_shard + 1,
            indices_are_sorted=True,
        )[: dcsr.rows_per_shard]
        return out[None]

    return _run(dcsr.rowptrs, dcsr.colinds, dcsr.values, b_dense.astype(dcsr.values.dtype))


def collect_rows(dcsr: DistCSR, y_sharded):
    """Assemble the global dense result vector (or matrix) from row-sharded
    per-shard outputs, dropping row padding
    (the distributed analog of reference csr/csr.py:623-650)."""
    parts = []
    nloc = jax.device_get(dcsr.nrows_local)
    for d in range(dcsr.n_shards):
        parts.append(y_sharded[d, : int(nloc[d])])
    return jnp.concatenate(parts, axis=0)
