"""
Row partitioning of CSR matrices over a device mesh.

This is the multi-device generalization of the reference's capacity-driven
row sharding (reference: csr/csr.py:599-650): instead of sequentially
computing shards that fit a kernel's ``max_nnz``, we split rows into
``n_shards`` nnz-balanced partitions, pad them to a common static shape,
and stack them so the leading axis can be laid out over a mesh axis with
``NamedSharding``/``shard_map``.

Padding keeps the per-device shapes static, which XLA requires; padded
entries have value 0 and column 0, so they never affect results.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from csr_tpu.dtypes import COLIND_DTYPE


def balanced_row_splits(rowptrs_host: np.ndarray, n_shards: int) -> np.ndarray:
    """nnz-balanced row split points: ``n_shards + 1`` boundaries.

    The descendant of the greedy searchsorted splitting in
    reference csr/csr.py:599-621, but targeting equal work per device
    rather than a capacity bound.
    """
    nnz = int(rowptrs_host[-1])
    nrows = len(rowptrs_host) - 1
    targets = (np.arange(1, n_shards) * nnz) // n_shards
    cuts = np.searchsorted(rowptrs_host, targets, side="left")
    splits = np.concatenate([[0], cuts, [nrows]])
    return np.maximum.accumulate(splits)


def balanced_col_splits(
    cols_host: np.ndarray, ncols: int, n_shards: int, align: int = 1
) -> np.ndarray:
    """nnz-balanced COLUMN split points: ``n_shards + 1`` boundaries,
    each a multiple of ``align`` (except the final ``ncols``).

    The column analog of :func:`balanced_row_splits`, used by the ring
    schedules: a uniform ``ncols / D`` column split sizes every ring
    bucket to the globally densest column stripe, inflating device
    memory by up to Dx on column-skewed matrices; nnz-balanced splits
    bound the max bucket near ``nnz / D`` (round-3 verdict item 8)."""
    counts = np.bincount(
        np.asarray(cols_host, dtype=np.int64), minlength=max(ncols, 1)
    )
    cum = np.concatenate([[0], np.cumsum(counts)])
    nnz = int(cum[-1])
    targets = (np.arange(1, n_shards) * nnz) // n_shards
    cuts = np.searchsorted(cum, targets, side="left")
    if align > 1:
        cuts = ((cuts + align // 2) // align) * align
        cuts = np.minimum(cuts, (ncols // align) * align)
    splits = np.concatenate([[0], cuts, [max(ncols, 1)]])
    return np.maximum.accumulate(splits).astype(np.int64)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["rowptrs", "colinds", "values", "row_offset", "nrows_local"],
    meta_fields=["nrows", "ncols", "nnz", "n_shards", "rows_per_shard",
                 "nnz_per_shard"],
)
@dataclass
class DistCSR:
    """A CSR matrix row-partitioned into ``n_shards`` padded shards.

    Arrays are stacked on a leading shard axis intended to be sharded over
    a mesh axis; ``row_offset[d]`` is the global row index of shard d's
    first row.  A pytree whose shapes are static, so the distributed ops
    can be jitted with it as an argument
    (``jax.jit(dist.spmv, static_argnames=("mesh", "axis"))``).
    """

    nrows: int
    ncols: int
    nnz: int
    n_shards: int
    rows_per_shard: int  # padded local row count
    nnz_per_shard: int  # padded local nnz
    rowptrs: jax.Array  # (D, rows_per_shard + 1) int32
    colinds: jax.Array  # (D, nnz_per_shard) int32
    values: jax.Array  # (D, nnz_per_shard) float32 (implicit 1s materialized)
    row_offset: jax.Array  # (D,) int32
    nrows_local: jax.Array  # (D,) int32 - real rows per shard

    def shard(self, mesh: Mesh, axis: str = "rows") -> "DistCSR":
        """Lay the shard axis out over ``mesh[axis]``."""
        sh = NamedSharding(mesh, P(axis))
        rep = NamedSharding(mesh, P())  # aux metadata replicated
        return DistCSR(
            self.nrows, self.ncols, self.nnz, self.n_shards,
            self.rows_per_shard, self.nnz_per_shard,
            jax.device_put(self.rowptrs, sh),
            jax.device_put(self.colinds, sh),
            jax.device_put(self.values, sh),
            jax.device_put(self.row_offset, rep),
            jax.device_put(self.nrows_local, rep),
        )


def partition_rows(csr, n_shards: int) -> DistCSR:
    """Partition a CSR into nnz-balanced, padded row shards."""
    rp = np.asarray(csr.rowptrs)
    splits = balanced_row_splits(rp, n_shards)
    values = csr._required_values()

    rows_per = int(np.max(np.diff(splits))) if n_shards else 0
    rows_per = max(rows_per, 1)
    shard_nnz = rp[splits[1:]] - rp[splits[:-1]]
    nnz_per = int(shard_nnz.max()) if len(shard_nnz) else 0
    nnz_per = max(nnz_per, 1)

    rps = np.zeros((n_shards, rows_per + 1), np.int32)
    cis = np.zeros((n_shards, nnz_per), np.int32)
    vls = np.zeros((n_shards, nnz_per), np.float32)
    cis_host = np.asarray(csr.colinds)
    vals_host = np.asarray(values, dtype=np.float32)

    for d in range(n_shards):
        r0, r1 = splits[d], splits[d + 1]
        s0, s1 = rp[r0], rp[r1]
        local = rp[r0 : r1 + 1] - rp[r0]
        rps[d, : r1 - r0 + 1] = local
        rps[d, r1 - r0 + 1 :] = local[-1]  # padded rows are empty
        cis[d, : s1 - s0] = cis_host[s0:s1]
        vls[d, : s1 - s0] = vals_host[s0:s1]

    return DistCSR(
        csr.nrows, csr.ncols, csr.nnz, n_shards, rows_per, nnz_per,
        jnp.asarray(rps), jnp.asarray(cis), jnp.asarray(vls),
        jnp.asarray(splits[:-1], dtype=np.int32),
        jnp.asarray(np.diff(splits), dtype=np.int32),
    )


def make_mesh(n_devices: int | None = None, axis: str = "rows") -> Mesh:
    """A 1-D device mesh over the row axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))
