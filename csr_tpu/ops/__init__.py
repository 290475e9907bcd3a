"""
Device algorithms behind the kernel contract.

:mod:`csr_tpu.ops.spgemm` holds the bounded-memory expand-sort-compress
SpGEMM that :mod:`csr_tpu.kernels.xla` runs when a product's dense
intermediates would not fit.
"""
