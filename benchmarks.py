"""
Kernel-comparative benchmark suite: the reference's six pytest-benchmark
groups (reference: tests/test_bench_multiply.py, tests/test_bench_mult_vec.py)
as a standalone script, parameterized over kernels.

Prints one JSON line per (group, kernel, param) with ms/op.  These are
end-to-end API timings (including handle creation), complementary to the
roofline-focused `bench.py`.

``--save`` additionally appends the run (with git revision, backend, and
timestamp metadata) to ``bench_history/`` — the saved-run comparison
workflow the reference gets from pytest-benchmark autosave
(reference: pytest.ini:7, Timings.py:19-39).  Compare runs with
``python timings_report.py --compare``.

Every row names the JAX device it ran on; ``scipy`` rows time the host.

Usage: python benchmarks.py [--kernels scipy,xla] [--fast] [--save]
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np
import scipy.sparse as sps

from csr_tpu import CSR
from csr_tpu.kernels import use_kernel
from csr_tpu.utils.compile_cache import enable_compile_cache

HISTORY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench_history")

_results = []


def make_csr(nrows, ncols, density, rng):
    m = sps.random(nrows, ncols, density, format="csr", random_state=rng)
    return CSR.from_scipy(m)


def timeit(fn, min_repeat=3, max_time=2.0):
    import jax

    jax.block_until_ready(fn())  # warmup / compile
    times = []
    t_total = 0.0
    while len(times) < min_repeat or t_total < max_time / 4:
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        dt = time.perf_counter() - t0
        times.append(dt)
        t_total += dt
        if len(times) >= 50:
            break
    return float(np.median(times) * 1e3)


def report(group, kernel, param, ms):
    import jax

    dev = jax.devices()[0]
    row = {"group": group, "kernel": kernel, "param": param,
           "ms_per_op": ms, "platform": dev.platform,
           "device_kind": dev.device_kind}
    _results.append(row)
    print(json.dumps(row))


def save_history(results):
    """Append this run to bench_history/ (git rev + backend + timestamp)."""
    import jax

    try:
        rev = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, cwd=os.path.dirname(HISTORY_DIR),
        ).stdout.strip() or "unknown"
    except OSError:
        rev = "unknown"
    ts = time.strftime("%Y%m%dT%H%M%S")
    os.makedirs(HISTORY_DIR, exist_ok=True)
    path = os.path.join(HISTORY_DIR, f"{ts}-{rev}.json")
    with open(path, "w") as f:
        json.dump(
            {
                "timestamp": ts,
                "git_rev": rev,
                "backend": jax.default_backend(),
                "device": str(jax.devices()[0]),
                "results": results,
            },
            f, indent=1,
        )
    print(f"# saved {len(results)} results to {path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="scipy,xla")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--save", action="store_true",
                    help="append this run to bench_history/")
    ap.add_argument("--only", default=None,
                    help="run only groups whose name contains this substring")
    args = ap.parse_args()
    enable_compile_cache()
    kernels = args.kernels.split(",")
    rng = np.random.default_rng(42)
    only = args.only

    def want(group):
        return only is None or only in group

    # fixed-workload groups (reference: tests/test_bench_multiply.py:9-24,66-81)
    A1 = make_csr(100, 500, 0.1, rng)
    B1 = make_csr(500, 200, 0.2, rng)
    At = make_csr(100, 500, 0.1, rng)
    Bt = make_csr(200, 500, 0.2, rng)
    Ax = make_csr(100, 100, 0.1, rng)
    v = rng.standard_normal(100)

    for k in kernels:
        with use_kernel(k):
            if want("MultAB"):
                report("MultAB", k, None, timeit(lambda: A1.multiply(B1)))
            if want("MultABt"):
                report("MultABt", k, None, timeit(lambda: At.multiply(Bt, transpose=True)))
            if want("MultAx"):
                report("MultAx", k, None, timeit(lambda: Ax.mult_vec(v)))

    densities = [] if not want("Density") else [0.1, 0.5, 1.0] if args.fast else [round(x, 1) for x in np.arange(0, 1.01, 0.1)]
    for dens in densities:
        Ad = make_csr(100, 100, dens, rng)
        Bd = make_csr(100, 100, dens, rng)
        for k in kernels:
            with use_kernel(k):
                report("MultAB-Density", k, dens, timeit(lambda: Ad.multiply(Bd)))
                report("MultABt-Density", k, dens, timeit(lambda: Ad.multiply(Bd, transpose=True)))

    sizes = [] if not want("MultAB-Size") else [10, 100, 500] if args.fast else [5, 10, 15, 25, 50, 100, 200, 250, 500, 750, 1000]
    for size in sizes:
        As = make_csr(size, size, 0.1, rng)
        Bs = make_csr(size, size, 0.1, rng)
        for k in kernels:
            with use_kernel(k):
                report("MultAB-Size", k, size, timeit(lambda: As.multiply(Bs)))

    # ESC-regime sizes: dense intermediates exceed the dense-routing
    # budget, so the xla backend's SpGEMM runs expand-sort-compress
    # (csr_tpu/ops/spgemm.py) — the reference's MultAB-Size sweep
    # (tests/test_bench_multiply.py:46-63) has no points here.  nnz/row is
    # held at ~50 so the expansion stays ~size * 2500 product terms.
    esc_sizes = [] if not want("ESC") else [20_000] if args.fast else [20_000, 50_000, 100_000]
    for size in esc_sizes:
        Ae = make_csr(size, size, 50.0 / size, rng)
        Be = make_csr(size, size, 50.0 / size, rng)
        for k in kernels:
            with use_kernel(k):
                ms = timeit(lambda: Ae.multiply(Be))
            gnnz = (Ae.nnz * 50.0) / (ms * 1e-3) / 1e9  # expanded terms/s
            report("MultAB-ESC", k, size, ms)
            print(json.dumps({"group": "MultAB-ESC-rate", "kernel": k,
                              "param": size,
                              "gterms_s": gnnz}))

    if args.save:
        save_history(_results)


if __name__ == "__main__":
    main()
