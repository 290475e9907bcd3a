"""
Ring SpMV: column-sharded operand with communication/compute overlap.

``spmv_halo`` (csr_tpu/parallel/dist.py) all-gathers the whole dense
operand before computing.  The alternative schedule is a **ring**: each
device holds one column shard of ``x``; at step ``k`` it multiplies the
sub-matrix whose columns live in the shard it currently holds, while
``ppermute`` passes shards to the neighbouring device over the
interconnect for the next step.  XLA overlaps the permute with the local segment-sum, hiding the
halo exchange behind compute (the distributed generalization the
reference's row sharding points at, SURVEY §5; reference sharding:
csr/csr.py:599-650).

Preprocessing buckets each row shard's entries by source column shard:
``bucket[d][k]`` holds the entries of row-shard ``d`` whose columns fall
in column-shard ``k``, with columns rebased to the shard.  Buckets are
padded to a common length so shapes stay static.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .partition import balanced_col_splits, balanced_row_splits


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["colinds", "values", "row_ids", "row_offset", "nrows_local",
                 "col_offset"],
    meta_fields=["nrows", "ncols", "nnz", "n_shards", "rows_per_shard",
                 "cols_per_shard", "bucket_len"],
)
@dataclass
class RingCSR:
    """Row-sharded CSR with entries bucketed by source column shard (a
    pytree, like :class:`~csr_tpu.parallel.partition.DistCSR`)."""

    nrows: int
    ncols: int
    nnz: int
    n_shards: int
    rows_per_shard: int
    cols_per_shard: int
    bucket_len: int
    # (D, D, L): [row shard, column shard, entry]
    colinds: jax.Array  # column index rebased to the column shard
    values: jax.Array   # 0 in padding slots
    row_ids: jax.Array  # row index rebased to the row shard
    row_offset: jax.Array  # (D,)
    nrows_local: jax.Array  # (D,)
    col_offset: np.ndarray = None  # (D+1,) host: nnz-balanced column splits

    def shard(self, mesh: Mesh, axis: str = "rows") -> "RingCSR":
        sh = NamedSharding(mesh, P(axis))
        return RingCSR(
            self.nrows, self.ncols, self.nnz, self.n_shards,
            self.rows_per_shard, self.cols_per_shard, self.bucket_len,
            jax.device_put(self.colinds, sh),
            jax.device_put(self.values, sh),
            jax.device_put(self.row_ids, sh),
            self.row_offset, self.nrows_local, self.col_offset,
        )


def partition_ring(csr, n_shards: int) -> RingCSR:
    """Bucket a CSR by (row shard, column shard) for the ring schedule.

    Column shards are nnz-balanced (:func:`balanced_col_splits`): buckets
    pad to the max bucket, so a uniform column split would inflate memory
    by up to Dx on column-skewed matrices."""
    rp = np.asarray(csr.rowptrs)
    cols = np.asarray(csr.colinds)
    vals = np.asarray(csr._required_values(), dtype=np.float32)
    rids = np.repeat(np.arange(csr.nrows, dtype=np.int32), np.diff(rp))

    splits = balanced_row_splits(rp, n_shards)
    csplits = balanced_col_splits(cols, csr.ncols, n_shards)
    cols_per = max(int(np.max(np.diff(csplits))), 1)
    rows_per = max(int(np.max(np.diff(splits))), 1)

    shard_of_row = np.searchsorted(splits[1:], rids, side="right")
    shard_of_col = np.searchsorted(csplits[1:], cols, side="right")

    L = 1
    counts = np.zeros((n_shards, n_shards), np.int64)
    for d in range(n_shards):
        sel = shard_of_row == d
        c = np.bincount(shard_of_col[sel], minlength=n_shards)
        counts[d] = c
    L = max(int(counts.max()), 1)

    ci = np.zeros((n_shards, n_shards, L), np.int32)
    vl = np.zeros((n_shards, n_shards, L), np.float32)
    ri = np.zeros((n_shards, n_shards, L), np.int32)
    for d in range(n_shards):
        sel_d = shard_of_row == d
        for k in range(n_shards):
            sel = sel_d & (shard_of_col == k)
            n = int(sel.sum())
            ci[d, k, :n] = cols[sel] - csplits[k]
            vl[d, k, :n] = vals[sel]
            ri[d, k, :n] = rids[sel] - splits[d]
            # padding rows point at the shard's padded extra row; value 0
            ri[d, k, n:] = rows_per

    return RingCSR(
        csr.nrows, csr.ncols, csr.nnz, n_shards, rows_per, cols_per, L,
        jnp.asarray(ci), jnp.asarray(vl), jnp.asarray(ri),
        jnp.asarray(splits[:-1].astype(np.int32)),
        jnp.asarray(np.diff(splits).astype(np.int32)),
        col_offset=csplits,
    )


def scatter_x(rcsr: RingCSR, x, mesh: Mesh, axis: str = "rows"):
    """Column-shard the dense operand along the nnz-balanced splits:
    a flat (D * cols_per_shard,) array, shard k holding its column slice
    zero-padded to the uniform ``cols_per_shard``."""
    d, cp = rcsr.n_shards, rcsr.cols_per_shard
    xs = np.zeros((d, cp), np.float32)
    xv = np.asarray(x, np.float32)
    cs = rcsr.col_offset
    for k in range(d):
        w = int(cs[k + 1] - cs[k])
        xs[k, :w] = xv[cs[k] : cs[k + 1]]
    arr = jnp.asarray(xs.reshape(-1))
    return jax.device_put(arr, NamedSharding(mesh, P(axis)))


def spmv_ring(rcsr: RingCSR, x_sharded, mesh: Mesh, axis: str = "rows"):
    """``y = A @ x`` with x column-sharded; shards rotate around the ring.

    ``x_sharded`` is the dense operand padded to ``D * cols_per_shard`` and
    sharded over ``mesh[axis]``.  Returns y as (D, rows_per_shard),
    row-sharded.
    """
    D = rcsr.n_shards

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(axis, None, None), P(axis)),
        out_specs=P(axis, None),
        check_vma=False,
    )
    def _run(ci, vl, ri, x_part):
        me = jax.lax.axis_index(axis)
        perm = [(i, (i - 1) % D) for i in range(D)]  # rotate shards downward

        def step(k, carry):
            x_cur, acc = carry
            # which column shard do we currently hold?
            held = (me + k) % D
            # overlap: next shard starts moving while we compute on x_cur
            x_next = jax.lax.ppermute(x_cur, axis, perm)
            # one dynamic bucket index — compile cost independent of D
            # (a lax.switch fan here compiles D full segment-sum branches)
            cb = jax.lax.dynamic_index_in_dim(ci[0], held, keepdims=False)
            vb = jax.lax.dynamic_index_in_dim(vl[0], held, keepdims=False)
            rb = jax.lax.dynamic_index_in_dim(ri[0], held, keepdims=False)
            contrib = jax.ops.segment_sum(
                vb * x_cur[cb], rb, num_segments=rcsr.rows_per_shard + 1
            )
            return (x_next, acc + contrib[: rcsr.rows_per_shard])

        acc0 = jnp.zeros(rcsr.rows_per_shard, vl.dtype)
        _, acc = jax.lax.fori_loop(0, D, step, (x_part, acc0))
        return acc[None, :]

    return _run(rcsr.colinds, rcsr.values, rcsr.row_ids, x_sharded)
