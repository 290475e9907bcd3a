"""
csr_tpu — compressed sparse row matrices on JAX devices.

A sparse linear algebra framework with the capabilities of the reference
``csr`` package (reference: csr/__init__.py): a CSR matrix type with
optional values, structure/transform operations, and pluggable compute
kernels — here backed by JAX/XLA, scaling over device meshes via row
partitioning.
"""

from .csr import CSR  # noqa: F401
from .constructors import (  # noqa: F401
    create,
    create_empty,
    create_from_sizes,
    create_novalues,
)

__version__ = "0.1.0"

__all__ = [
    "CSR",
    "create",
    "create_empty",
    "create_from_sizes",
    "create_novalues",
]
