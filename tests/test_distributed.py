"""Distributed row-partitioning tests on the 8-device virtual CPU mesh.

The reference has no distributed layer; these tests exercise the mesh
row-partitioning that generalizes its capacity sharding
(reference: csr/csr.py:599-650), using the shrunken-scale pattern of
tests/test_mkl.py:29-38 — small matrices over many (virtual) devices.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from hypothesis import given, settings
import hypothesis.strategies as st

import chip_smoke
from csr_tpu.parallel import dist, ring
from csr_tpu.parallel.partition import balanced_row_splits, make_mesh, partition_rows
from csr_tpu.test_utils import csrs
from csr_tpu.utils import tolerance
from util import assert_spmv_close, to_dense

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs a multi-device mesh"
)


@given(st.data())
def test_balanced_splits(data):
    csr = data.draw(csrs(nrows=st.integers(8, 60)))
    n = data.draw(st.sampled_from([2, 4, 8]))
    rp = np.asarray(csr.rowptrs)
    splits = balanced_row_splits(rp, n)
    assert len(splits) == n + 1
    assert splits[0] == 0 and splits[-1] == csr.nrows
    assert np.all(np.diff(splits) >= 0)


@given(st.data())
def test_partition_roundtrip(data):
    csr = data.draw(csrs(nrows=st.integers(8, 60)))
    d = partition_rows(csr, 4)
    dense = to_dense(csr)
    # reassemble from shards
    rps = np.asarray(d.rowptrs)
    cis = np.asarray(d.colinds)
    vls = np.asarray(d.values)
    nloc = np.asarray(d.nrows_local)
    off = np.asarray(d.row_offset)
    out = np.zeros_like(dense, dtype=np.float32)
    for s in range(4):
        for i in range(int(nloc[s])):
            a, b = rps[s, i], rps[s, i + 1]
            for j in range(a, b):
                out[off[s] + i, cis[s, j]] += vls[s, j]
    np.testing.assert_allclose(out, dense, rtol=1e-4, atol=1e-3)


@needs_devices
@given(st.data())
@settings(max_examples=10, deadline=None)
def test_dist_spmv(data):
    csr = data.draw(csrs(nrows=st.integers(8, 60), values=True))
    n = min(len(jax.devices()), 8)
    mesh = make_mesh(n)
    d = partition_rows(csr, n).shard(mesh)
    x = data.draw(
        st.lists(
            st.floats(-10, 10, allow_nan=False, width=32),
            min_size=csr.ncols, max_size=csr.ncols,
        )
    )
    x = np.asarray(x, np.float32)
    y = dist.spmv(d, jnp.asarray(x), mesh)
    yg = np.asarray(dist.collect_rows(d, y))
    ref = to_dense(csr).astype(np.float64) @ x.astype(np.float64)
    assert_spmv_close(yg, ref, csr, x)


@needs_devices
def test_dist_spmv_halo_and_t():
    import scipy.sparse as sps

    rng = np.random.default_rng(7)
    m = sps.random(96, 64, 0.08, format="csr", random_state=rng)
    from csr_tpu import CSR

    csr = CSR.from_scipy(m)
    n = min(len(jax.devices()), 8)
    mesh = make_mesh(n)
    d = partition_rows(csr, n).shard(mesh)
    x = rng.standard_normal(64).astype(np.float32)

    # column-sharded operand with halo all-gather
    pad = -(-64 // n) * n
    xp = np.zeros(pad, np.float32)
    xp[:64] = x
    y = dist.spmv_halo(d, jnp.asarray(xp), mesh)
    yg = np.asarray(dist.collect_rows(d, y))
    ref = m @ x
    np.testing.assert_allclose(yg, ref, rtol=1e-4, atol=1e-4)

    # transpose direction with psum reduction
    yt = np.asarray(dist.spmv_t(d, y, mesh))
    np.testing.assert_allclose(yt, m.T @ ref, rtol=1e-4, atol=1e-3)


@needs_devices
def test_dist_spmm():
    import scipy.sparse as sps

    rng = np.random.default_rng(3)
    m = sps.random(80, 40, 0.1, format="csr", random_state=rng)
    from csr_tpu import CSR

    csr = CSR.from_scipy(m)
    n = min(len(jax.devices()), 8)
    mesh = make_mesh(n)
    d = partition_rows(csr, n).shard(mesh)
    B = rng.standard_normal((40, 12)).astype(np.float32)
    C = dist.spmm(d, jnp.asarray(B), mesh)
    Cg = np.asarray(dist.collect_rows(d, C))
    np.testing.assert_allclose(Cg, m @ B, rtol=1e-4, atol=1e-3)


@needs_devices
def test_ring_spmv():
    """Ring-scheduled SpMV: column shards rotate via ppermute, compute
    overlaps communication."""
    import scipy.sparse as sps

    from csr_tpu.parallel import ring

    rng = np.random.default_rng(11)
    m = sps.random(160, 120, 0.1, format="csr", random_state=rng)
    from csr_tpu import CSR

    csr = CSR.from_scipy(m)
    n = min(len(jax.devices()), 8)
    mesh = make_mesh(n)
    r = ring.partition_ring(csr, n).shard(mesh)
    x = rng.standard_normal(120).astype(np.float32)
    xs = ring.scatter_x(r, x, mesh)
    y = ring.spmv_ring(r, xs, mesh)
    yg = np.asarray(dist.collect_rows(r, y))
    np.testing.assert_allclose(yg, m @ x, rtol=1e-4, atol=1e-4)


def test_ring_buckets_nnz_balanced():
    """Power-law column skew: nnz-balanced column splits keep the padded
    max bucket within 2x of ideal, where uniform splits blow up toward Dx
    (round-3 verdict item 8)."""
    from csr_tpu import CSR
    from csr_tpu.parallel import ring

    rng = np.random.default_rng(23)
    nrows, ncols, npr = 256, 2048, 64
    # power-law column distribution: most mass in the first columns
    cols = np.minimum(
        (ncols * rng.power(0.25, nrows * npr)).astype(np.int64), ncols - 1
    ).astype(np.int32)
    rowptr = np.arange(nrows + 1, dtype=np.int64) * npr
    vals = np.ones(nrows * npr, np.float32)
    csr = CSR(nrows, ncols, nrows * npr, rowptr, np.sort(
        cols.reshape(nrows, npr), axis=1).reshape(-1), vals)

    D = 8
    r = ring.partition_ring(csr, D)
    ideal = csr.nnz / (D * D)  # per (row shard, col shard) bucket
    assert r.bucket_len <= 2 * max(ideal, 1) + npr
    # the uniform split really is pathological on this matrix (sanity
    # check that the test matrix has the skew it claims)
    uni = np.bincount(
        np.minimum(cols // (-(-ncols // D)), D - 1), minlength=D
    ).max()
    assert uni > 4 * (csr.nnz / D)

    x = rng.standard_normal(ncols).astype(np.float32)
    mesh = make_mesh(min(len(jax.devices()), D))
    if mesh.devices.size == D:
        rs = r.shard(mesh)
        xs = ring.scatter_x(rs, x, mesh)
        y = np.asarray(ring.spmv_ring(rs, xs, mesh))
        yg = np.asarray(dist.collect_rows(rs, y))
        ref = to_dense(csr) @ x
        np.testing.assert_allclose(yg, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("op", chip_smoke.MESH_OPS)
def test_mesh_op_skewed(op, n_dev):
    """Every mesh operation against scipy on a skewed matrix (1% of the
    rows hold half the entries), jitted with the partitioned matrix as a
    pytree argument, at each mesh size."""
    if len(jax.devices()) < n_dev:
        pytest.skip(f"needs {n_dev} devices")
    rng = np.random.default_rng(n_dev)
    n = 50 * n_dev
    a, ref = chip_smoke.random_csr(
        rng, n, n, chip_smoke.skewed_row_nnz(rng, n, n * 6)
    )
    mesh = make_mesh(n_dev)
    parts = {"rows": partition_rows(a, n_dev).shard(mesh),
             "ring": ring.partition_ring(a, n_dev).shard(mesh)}
    fn, args, gather, want, mass = chip_smoke.mesh_op(op, parts, ref, mesh,
                                                      rng, k=3)
    tolerance.check(gather(fn(*args)), want, mass, np.float32, op)
