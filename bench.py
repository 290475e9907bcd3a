"""
Flagship benchmark: ``CSR.mult_vec`` through the public API at 10.7M nnz
(32768 x 32768, 327 entries per row, uniform random columns, f32) on one
GPU.

Prints ONE JSON line:
    {"metric": "spmv_eff_gbps", "value": <effective GB/s>, "unit": "GB/s",
     "vs_peak": <share of the card's device-memory bandwidth>, ...}
with the device (platform, device_kind, count) and the card's name and
power limit beside the number.

Effective bytes are the ideal CSR traffic (8 B per entry, the row
pointers, x and y; :func:`csr_tpu.utils.profiling.csr_mult_bytes`).  The
time is the median of 50 calls after a warm-up call, each ending in
``block_until_ready``.  Without a GPU the script fails: a host timing is
no device metric.
"""

import json
import sys

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from csr_tpu import CSR
    from csr_tpu.utils.compile_cache import enable_compile_cache
    from csr_tpu.utils.profiling import (
        card_name_and_power_limit, csr_mult_bytes, peak_hbm_bytes_per_s, timed,
    )

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: no GPU (JAX backend is {jax.default_backend()!r})")
    dev = jax.devices()[0]

    nrows = ncols = 32768
    npr = 327
    nnz = nrows * npr
    rng = np.random.default_rng(0)
    rowptr = np.arange(nrows + 1, dtype=np.int64) * npr
    cols = rng.integers(0, ncols, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    csr = CSR(nrows, ncols, nnz, rowptr, cols, vals)
    x = jnp.asarray(rng.standard_normal(ncols).astype(np.float32))

    dt = timed(csr.mult_vec, x, iters=50)
    gbps = csr_mult_bytes(nrows, ncols, nnz) / dt / 1e9
    result = {
        "metric": "spmv_eff_gbps",
        "value": gbps,
        "unit": "GB/s",
        "vs_peak": gbps * 1e9 / peak_hbm_bytes_per_s(dev.device_kind),
        "ms": dt * 1e3,
        "gnnz_s": nnz / dt / 1e9,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_name_and_power_limit(),
    }
    print(f"# nnz={nnz} t={dt * 1e3:.4f}ms", file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
