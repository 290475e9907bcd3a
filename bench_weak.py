"""
Weak-scaling benchmark for the distributed SpMV.

For each device count D (1, 2, 4, ... up to the devices present): a
square matrix with ``rows_per_device * D`` rows and a fixed number of
entries per row (constant work per device), row-partitioned over a
D-device mesh, runs the halo form (``dist.spmv_halo``: the column-sharded
operand is all-gathered before the local product) or, with ``--ring``,
the ring form (``ring.spmv_ring``: operand shards rotate with
``ppermute`` while each device multiplies the bucket it holds).

Prints one JSON line per D with the median time of a jitted call (each
ending in ``block_until_ready``), nnz/s and efficiency against D=1,
beside the device and the cards' names and power limits.  Without a GPU
the script fails: a host timing is no device metric.
"""

import argparse
import functools
import json

import numpy as np


def run(n_devices: int, rows_per_device: int, npr: int, iters: int,
        ring: bool = False):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from csr_tpu import CSR
    from csr_tpu.parallel import dist, ring as ring_mod
    from csr_tpu.parallel.partition import make_mesh, partition_rows
    from csr_tpu.utils.profiling import timed

    nrows = ncols = rows_per_device * n_devices
    nnz = nrows * npr
    rng = np.random.default_rng(0)
    rowptr = np.arange(nrows + 1, dtype=np.int64) * npr
    cols = rng.integers(0, ncols, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    csr = CSR(nrows, ncols, nnz, rowptr, cols, vals)
    x = rng.standard_normal(ncols).astype(np.float32)

    mesh = make_mesh(n_devices)
    jit = functools.partial(jax.jit, static_argnames=("mesh", "axis"))
    if ring:
        r = ring_mod.partition_ring(csr, n_devices).shard(mesh)
        fn, args = jit(ring_mod.spmv_ring), (r, ring_mod.scatter_x(r, x, mesh), mesh)
    else:
        d = partition_rows(csr, n_devices).shard(mesh)
        xp = np.zeros(-(-ncols // n_devices) * n_devices, np.float32)
        xp[:ncols] = x
        xs = jax.device_put(jnp.asarray(xp), NamedSharding(mesh, P("rows")))
        fn, args = jit(dist.spmv_halo), (d, xs, mesh)
    return nnz, timed(fn, *args, iters=iters)


def main():
    import jax

    from csr_tpu.utils.compile_cache import enable_compile_cache
    from csr_tpu.utils.profiling import card_name_and_power_limit

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-device", type=int, default=16384)
    ap.add_argument("--nnz-per-row", type=int, default=327)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--max-devices", type=int, default=None)
    ap.add_argument("--ring", action="store_true",
                    help="ring schedule (ppermute overlap) instead of halo")
    args = ap.parse_args()

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench_weak: no GPU (JAX backend is {jax.default_backend()!r})"
        )
    dev = jax.devices()[0]
    card = card_name_and_power_limit()
    n_dev = len(jax.devices())
    if args.max_devices:
        n_dev = min(n_dev, args.max_devices)
    base_rate = None
    d = 1
    while d <= n_dev:
        nnz, dt = run(d, args.rows_per_device, args.nnz_per_row, args.iters,
                      ring=args.ring)
        rate = nnz / dt / 1e9
        if base_rate is None:
            base_rate = rate
        print(json.dumps({
            "group": "WeakScaling-Ring" if args.ring else "WeakScaling",
            "devices": d, "nnz": nnz,
            "ms_per_iter": dt * 1e3,
            "gnnz_per_s": rate,
            "efficiency": rate / (base_rate * d),
            "device": {"platform": dev.platform, "kind": dev.device_kind},
            "card": card,
        }))
        d *= 2


if __name__ == "__main__":
    main()
