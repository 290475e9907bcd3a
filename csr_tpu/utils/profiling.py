"""
Device peaks, timing and byte accounting for the benchmarks.

* :data:`PEAK_HBM_BYTES_PER_S` — the one peak table, keyed by the
  ``device_kind`` JAX reports; :func:`peak_hbm_bytes_per_s` reads it and
  raises for a device it does not hold.
* :func:`card_name_and_power_limit` — ``nvidia-smi``'s name and power
  limit of each card, printed beside every measurement.
* :func:`timed` — median wall-clock seconds of a call, synchronised with
  ``block_until_ready``.
* :func:`csr_mult_bytes` — the bytes an ideal CSR SpMV or SpMM moves.
"""

from __future__ import annotations

import subprocess
import time

import jax

#: Device-memory bandwidth in bytes/s, by ``jax.Device.device_kind``.
#: Source: NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column
#: (80 GB HBM3 at 3.35 TB/s, at the full 700 W power limit).
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_hbm_bytes_per_s(device_kind: str | None = None) -> float:
    """Peak device-memory bandwidth of ``device_kind`` (default: the first
    JAX device).  A device missing from the table is an error, never a
    default."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAK_HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak bandwidth recorded for device kind {device_kind!r}; "
            f"known: {sorted(PEAK_HBM_BYTES_PER_S)}"
        ) from None


def card_name_and_power_limit() -> str:
    """The cards' names and power limits, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them.  A card set below its maximum power runs slower under
    load, so every number taken on it is reported with this."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def timed(fn, *args, iters: int = 10) -> float:
    """Median wall-clock seconds per call of ``fn(*args)``, after one
    warm-up call; every call ends in ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def csr_mult_bytes(nrows: int, ncols: int, nnz: int, k: int = 1,
                   value_bytes: int = 4, index_bytes: int = 4) -> int:
    """Bytes an ideal CSR SpMV (``k == 1``) or SpMM with ``k`` dense
    columns reads and writes once each: a value and a column index per
    entry, the row pointers, the dense operand and the result (the usual
    "effective bandwidth" convention for sparse products)."""
    return (nnz * (value_bytes + index_bytes) + (nrows + 1) * index_bytes
            + (nrows + ncols) * k * value_bytes)
