"""
Smoke run of csr_tpu's main path on an NVIDIA GPU.

Every phase runs in this one process (one JAX process per card), through
the public ``CSR`` API on the default ``xla`` kernel, at the sizes the
repository documents, on random matrices made from ``--seed``.  Each
phase compares its results with scipy in float64 under the bounds of
:mod:`csr_tpu.utils.tolerance` and prints one line per operation: the
largest error beside its tolerance, and the median wall time of the call
after a warm-up call, each call ending in ``block_until_ready``.  A
mismatch raises; no phase catches its own failure.

    python chip_smoke.py            # phases 1-6 on one card
    python chip_smoke.py --multi    # only the row-partitioned mesh path,
                                    # on 4 cards

The card's name and power limit are printed as ``nvidia-smi`` gives them.
The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np
import scipy.sparse as sps

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from csr_tpu import CSR, native
from csr_tpu.kernels import get_kernel
from csr_tpu.ops import spgemm
from csr_tpu.parallel import dist, ring
from csr_tpu.parallel.partition import make_mesh, partition_rows
from csr_tpu.utils import tolerance
from csr_tpu.utils.compile_cache import enable_compile_cache
from csr_tpu.utils.profiling import (
    card_name_and_power_limit, csr_mult_bytes, peak_hbm_bytes_per_s, timed,
)

#: The sizes the repository documents: the flagship SpMV (bench.py), the
#: SpMM shape, the dense-route and ESC SpGEMM points (benchmarks.py) and
#: the weak-scaling shape (bench_weak.py).
FULL = dict(
    spmv_n=32768, spmv_npr=327,
    spmm_n=4096, spmm_density=0.02, spmm_k=256,
    esc_n=20_000, esc_npr=50,
    rows_per_device=16384, multi_npr=327, multi_k=32,
)
MULTI_DEVICES = 4


# -- matrices ---------------------------------------------------------------


def random_csr(rng, nrows, ncols, row_nnz, dtype=np.float32):
    """A matrix with ``row_nnz[i]`` entries in row ``i``, uniform random
    columns (repeats allowed, as in bench.py) and standard-normal values.
    Returns the device ``CSR`` and the same matrix as a float64 scipy
    ``csr_matrix``."""
    rowptr = np.zeros(nrows + 1, np.int64)
    np.cumsum(row_nnz, out=rowptr[1:])
    nnz = int(rowptr[-1])
    cols = rng.integers(0, ncols, nnz, dtype=np.int32)
    vals = rng.standard_normal(nnz).astype(dtype)
    # scipy sums duplicates in place (abs() does), and on the CPU the
    # device arrays may alias these numpy buffers: give scipy its own
    ref = sps.csr_matrix((vals.astype(np.float64), cols.copy(), rowptr.copy()),
                         shape=(nrows, ncols))
    return CSR(nrows, ncols, nnz, rowptr, cols, vals), ref


def skewed_row_nnz(rng, nrows, nnz, hub_frac=0.01, hub_share=0.5):
    """Entries per row for ``nnz`` entries of which ``hub_share`` sit in a
    random ``hub_frac`` of the rows."""
    hubs = rng.choice(nrows, max(1, round(hub_frac * nrows)), replace=False)
    rest = np.setdiff1d(np.arange(nrows), hubs)
    counts = np.zeros(nrows, np.int64)
    for rows, total in ((hubs, int(nnz * hub_share)),
                        (rest, nnz - int(nnz * hub_share))):
        base, extra = divmod(total, len(rows))
        counts[rows] = base
        counts[rows[:extra]] += 1
    return counts


def row_nnz_for(rng, kind, nrows, npr):
    if kind == "uniform":
        return np.full(nrows, npr, np.int64)
    return skewed_row_nnz(rng, nrows, nrows * npr)


# -- reporting --------------------------------------------------------------


def report(phase, op, what, err_tol, seconds, **extra):
    err, tol = err_tol
    fields = [f"phase={phase}", f"op={op}", f"matrix={what}",
              f"max_err={err:.3e}", f"tol={tol:.3e}",
              f"time_ms={seconds * 1e3}"]
    fields += [f"{k}={v}" for k, v in extra.items()]
    print(" ".join(fields), flush=True)


def rates(nbytes, seconds, peak):
    """Effective bytes/s and its share of the device peak; nothing when
    no device peak is given (a host run measures no device)."""
    if not peak:
        return {}
    return {"eff_GBps": nbytes / seconds / 1e9,
            "peak_share": nbytes / seconds / peak}


def describe(a, dtype):
    return f"{a.nrows}x{a.ncols}/nnz={a.nnz}/{np.dtype(dtype).name}"


# -- phases -----------------------------------------------------------------


def phase_device(min_devices=1):
    """Phase 1: the device, the card, the native library and the kernel.
    Exits (non-zero, before any result) when JAX finds no GPU."""
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX backend is {jax.default_backend()!r})"
        )
    devs = jax.devices()
    if len(devs) < min_devices:
        raise SystemExit(
            f"chip_smoke: needs {min_devices} GPUs, JAX sees {len(devs)}"
        )
    d = devs[0]
    print(f"phase=device platform={d.platform} kind={d.device_kind!r} "
          f"count={len(devs)}", flush=True)
    print(card_name_and_power_limit(), flush=True)
    kernel = get_kernel().__name__.rsplit(".", 1)[-1]
    print(f"phase=device native_library="
          f"{'loaded' if native.available() else 'unavailable'} "
          f"kernel={kernel}", flush=True)
    assert kernel == "xla", kernel
    return d


def phase_spmv(rng, n, npr, dtype=np.float32, ops=("mult_vec", "mult_vec_t"),
               peak=None):
    """Phase 2: SpMV and SpMV-T on a uniform and a skewed matrix (1% of
    the rows hold half the entries) of the same nnz."""
    vb = np.dtype(dtype).itemsize
    for kind in ("uniform", "skewed"):
        a, ref = random_csr(rng, n, n, row_nnz_for(rng, kind, n, npr), dtype)
        abs_a = abs(ref)
        x = rng.standard_normal(n).astype(dtype)
        xd = jnp.asarray(x)
        for op in ops:
            fn = getattr(a, op)
            m, am = (ref, abs_a) if op == "mult_vec" else (ref.T, abs_a.T)
            et = tolerance.check(fn(xd), m @ x.astype(np.float64),
                                 am @ np.abs(x.astype(np.float64)), dtype,
                                 f"{op} {kind}")
            s = timed(fn, xd, iters=20)
            nbytes = csr_mult_bytes(n, n, a.nnz, value_bytes=vb)
            report("spmv", op, f"{kind}/{describe(a, dtype)}", et, s,
                   **rates(nbytes, s, peak))


def phase_spmm(rng, n, density, k, dtype=np.float32, peak=None):
    """Phase 3: SpMM ``A @ B`` with dense B of ``k`` columns."""
    a, ref = random_csr(rng, n, n, np.full(n, round(density * n)), dtype)
    b = rng.standard_normal((n, k)).astype(dtype)
    bd = jnp.asarray(b)
    b64 = b.astype(np.float64)
    et = tolerance.check(a.mult_dense(bd), ref @ b64, abs(ref) @ np.abs(b64),
                         dtype, "mult_dense")
    s = timed(a.mult_dense, bd)
    nbytes = csr_mult_bytes(n, n, a.nnz, k=k, value_bytes=np.dtype(dtype).itemsize)
    report("spmm", "mult_dense", f"{describe(a, dtype)}/k={k}", et, s,
           **rates(nbytes, s, peak))


def phase_spgemm(rng, dense_n, density, esc_n, esc_npr, dtype=np.float32,
                 peak=None):
    """Phase 4: SpGEMM ``A @ B`` and ``A @ B^T`` on the dense route and on
    the expand-sort-compress (ESC) route; the product's structure must
    equal scipy's after zero-filtering."""
    vb = np.dtype(dtype).itemsize
    for route, n, npr in (("dense", dense_n, round(density * dense_n)),
                          ("esc", esc_n, esc_npr)):
        a, ra = random_csr(rng, n, n, np.full(n, npr), dtype)
        b, rb = random_csr(rng, n, n, np.full(n, npr), dtype)
        a_cols = ra.indices.copy()  # before abs() below sums ra's duplicates
        for transpose in (False, True):
            rbt = (rb.T if transpose else rb).tocsr()
            taken = "dense" if spgemm.dense_fits(n, n, n, n) else "esc"
            assert taken == route, (route, taken)

            def fn():
                return a.multiply(b, transpose=transpose)

            # product terms that A's stored entries expand to
            terms = int(np.diff(rbt.indptr)[a_cols].sum())
            c = fn()
            *et, one_sided = tolerance.check_sparse(
                c.to_scipy(), ra @ rbt, abs(ra) @ abs(rbt), dtype,
                f"multiply {route} t={transpose}")
            s = timed(fn, iters=3)
            io = (a.nnz + b.nnz + c.nnz) * (vb + 4) + 3 * (n + 1) * 4
            op = "multiply_t" if transpose else "multiply"
            report("spgemm", op, f"{route}/{describe(a, dtype)}", et, s,
                   out_nnz=c.nnz, one_sided=one_sided, terms_per_s=terms / s,
                   **rates(io, s, peak))


def _row_sorted(m):
    """Column indices and values of a scipy CSR matrix, sorted within each
    row by (column, value): a canonical order that keeps duplicates."""
    rows = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
    order = np.lexsort((m.data, m.indices, rows))
    return m.indices[order], m.data[order]


def phase_structure(rng, n, npr):
    """Phase 5: transpose and the two row normalizations."""
    a, ref = random_csr(rng, n, n, np.full(n, npr), np.float32)
    what = describe(a, np.float32)

    t = a.transpose().to_scipy()
    want = ref.T.tocsr()
    if not (np.array_equal(t.indptr, want.indptr)
            and all(map(np.array_equal, _row_sorted(t), _row_sorted(want)))):
        raise AssertionError("transpose differs from scipy's")
    report("structure", "transpose", what, (0.0, 0.0),
           timed(a.transpose))

    # per-entry references in the device's entry order
    counts = np.diff(np.asarray(a.rowptrs))
    vals = np.asarray(a.values, np.float64)
    rows = np.repeat(np.arange(n), counts)
    safe = np.maximum(counts, 1)
    mean_ref = np.bincount(rows, vals, n) / safe
    abs_mean = np.bincount(rows, np.abs(vals), n) / safe

    c = a.copy()
    means = c.normalize_rows("center")
    err_m = tolerance.check(means, mean_ref, abs_mean, np.float32, "center means")
    err_v = tolerance.check(c.values, vals - mean_ref[rows],
                            np.abs(vals) + abs_mean[rows], np.float32,
                            "centered values")
    work = a.copy()
    report("structure", "normalize_center", what, max(err_m, err_v),
           timed(work.normalize_rows, "center"))

    c = a.copy()
    norms = c.normalize_rows("unit")
    norm_ref = np.sqrt(np.bincount(rows, vals * vals, n))
    err_n = tolerance.check(norms, norm_ref, norm_ref, np.float32, "unit norms")
    unit_ref = vals / np.where(norm_ref > 0, norm_ref, 1)[rows]
    err_v = tolerance.check(c.values, unit_ref, np.abs(unit_ref), np.float32,
                            "unit values")
    work = a.copy()
    report("structure", "normalize_unit", what, max(err_n, err_v),
           timed(work.normalize_rows, "unit"))


def phase_f64(rng, sizes, peak=None):
    """Phase 6: ``mult_vec``, ``mult_dense`` and ``multiply`` with float64
    values, at the sizes of phases 2-4."""
    with jax.enable_x64(True):
        phase_spmv(rng, sizes["spmv_n"], sizes["spmv_npr"], np.float64,
                   ops=("mult_vec",), peak=peak)
        phase_spmm(rng, sizes["spmm_n"], sizes["spmm_density"],
                   sizes["spmm_k"], np.float64, peak=peak)
        phase_spgemm(rng, sizes["spmm_n"], sizes["spmm_density"],
                     sizes["esc_n"], sizes["esc_npr"], np.float64, peak=peak)


#: the row-partitioned mesh operations
MESH_OPS = ("dist.spmv", "dist.spmv_halo", "dist.spmv_t", "dist.spmm",
            "ring.spmv_ring")


def mesh_op(op, parts, ref, mesh, rng, k):
    """One mesh operation, ready to run: returns ``(fn, args, gather,
    want, bound_mass)``, where ``gather`` turns ``fn(*args)`` into the
    global host result, ``want`` is scipy's float64 result and
    ``bound_mass`` the ``|A| @ |x|`` of :mod:`csr_tpu.utils.tolerance`.
    ``parts`` holds the matrix partitioned for ``dist`` (``"rows"``) and
    for ``ring`` (``"ring"``)."""
    jit = functools.partial(jax.jit, static_argnames=("mesh", "axis"))
    d, n_dev = parts["rows"], mesh.devices.size
    n = d.nrows
    abs_a = abs(ref)
    x = rng.standard_normal(n).astype(np.float32)
    x64 = x.astype(np.float64)
    gather = functools.partial(dist.collect_rows, d)
    if op == "dist.spmv":
        return (jit(dist.spmv), (d, jnp.asarray(x), mesh), gather,
                ref @ x64, abs_a @ np.abs(x64))
    if op == "dist.spmv_halo":
        xp = np.zeros(-(-n // n_dev) * n_dev, np.float32)
        xp[:n] = x
        xs = jax.device_put(jnp.asarray(xp), NamedSharding(mesh, P("rows")))
        return (jit(dist.spmv_halo), (d, xs, mesh), gather,
                ref @ x64, abs_a @ np.abs(x64))
    if op == "dist.spmv_t":
        # x plays y's part: a row-space vector in the row-sharded layout
        xpad = np.zeros((n_dev, d.rows_per_shard), np.float32)
        off, nloc = np.asarray(d.row_offset), np.asarray(d.nrows_local)
        for i in range(n_dev):
            xpad[i, : nloc[i]] = x[off[i] : off[i] + nloc[i]]
        return (jit(dist.spmv_t), (d, jnp.asarray(xpad), mesh), np.asarray,
                ref.T @ x64, abs_a.T @ np.abs(x64))
    if op == "dist.spmm":
        b = rng.standard_normal((n, k)).astype(np.float32)
        b64 = b.astype(np.float64)
        return (jit(dist.spmm), (d, jnp.asarray(b), mesh), gather,
                ref @ b64, abs_a @ np.abs(b64))
    if op == "ring.spmv_ring":
        r = parts["ring"]
        return (jit(ring.spmv_ring), (r, ring.scatter_x(r, x, mesh), mesh),
                functools.partial(dist.collect_rows, r),
                ref @ x64, abs_a @ np.abs(x64))
    raise ValueError(f"unknown mesh op {op!r}")


def phase_multi(rng, n_devices, rows_per_device, npr, k, kind="uniform",
                peak=None):
    """The row-partitioned mesh path on ``n_devices`` devices: every op of
    :data:`MESH_OPS`, each against scipy."""
    mesh = make_mesh(n_devices)
    n = rows_per_device * n_devices
    a, ref = random_csr(rng, n, n, row_nnz_for(rng, kind, n, npr))
    parts = {"rows": partition_rows(a, n_devices).shard(mesh),
             "ring": ring.partition_ring(a, n_devices).shard(mesh)}
    what = f"{kind}/{describe(a, np.float32)}/D={n_devices}"
    card_peak = peak * n_devices if peak else None
    for op in MESH_OPS:
        fn, args, gather, want, mass = mesh_op(op, parts, ref, mesh, rng, k)
        et = tolerance.check(gather(fn(*args)), want, mass, np.float32, op)
        s = timed(fn, *args)
        kk = k if op == "dist.spmm" else 1
        report("multi", op, what + (f"/k={k}" if kk > 1 else ""), et, s,
               **rates(csr_mult_bytes(n, n, a.nnz, k=kk), s, card_peak))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help=f"run only the row-partitioned mesh path, on "
                         f"{MULTI_DEVICES} cards")
    args = ap.parse_args(argv)

    enable_compile_cache()
    dev = phase_device(MULTI_DEVICES if args.multi else 1)
    peak = peak_hbm_bytes_per_s(dev.device_kind)
    rng = np.random.default_rng(args.seed)
    f = FULL
    if args.multi:
        phase_multi(rng, MULTI_DEVICES, f["rows_per_device"], f["multi_npr"],
                    f["multi_k"], peak=peak)
    else:
        phase_spmv(rng, f["spmv_n"], f["spmv_npr"], peak=peak)
        phase_spmm(rng, f["spmm_n"], f["spmm_density"], f["spmm_k"], peak=peak)
        phase_spgemm(rng, f["spmm_n"], f["spmm_density"], f["esc_n"],
                     f["esc_npr"], peak=peak)
        phase_structure(rng, f["spmv_n"], f["spmv_npr"])
        phase_f64(rng, f, peak=peak)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
