"""
Checkpoint / serialization for CSR matrices.

The reference's only persistence is pickling (reference: csr/csr.py:690-692,
tests/test_pickle.py).  Pickle works here too (the CSR ``__reduce__``
round-trips through host arrays); this module adds two more:

* :func:`save_npz` / :func:`load_npz` — portable single-file archive,
  scipy-``save_npz``-compatible field names plus a marker for
  structure-only matrices;
* :func:`to_state_dict` / :func:`from_state_dict` — a flat pytree mapping
  for checkpointing through orbax/flax alongside model state.
"""

from __future__ import annotations

import numpy as np

from csr_tpu.csr import CSR


def to_state_dict(csr: CSR) -> dict:
    """Flat array mapping for pytree checkpointers (orbax etc.)."""
    d = {
        "rowptrs": csr.rowptrs,
        "colinds": csr.colinds,
        "shape": np.asarray([csr.nrows, csr.ncols], np.int64),
    }
    if csr.values is not None:
        d["values"] = csr.values
    return d


def from_state_dict(d) -> CSR:
    nrows, ncols = (int(x) for x in np.asarray(d["shape"]))
    cis = d["colinds"]
    return CSR(
        nrows, ncols, int(np.asarray(cis).shape[0]),
        d["rowptrs"], cis, d.get("values"),
    )


def save_npz(path, csr: CSR, compressed: bool = True):
    """Save to an ``.npz`` archive (host-side)."""
    arrays = {
        "rowptrs": np.asarray(csr.rowptrs),
        "colinds": np.asarray(csr.colinds),
        "shape": np.asarray([csr.nrows, csr.ncols], np.int64),
        "has_values": np.asarray(csr.values is not None),
    }
    if csr.values is not None:
        arrays["values"] = np.asarray(csr.values)
    (np.savez_compressed if compressed else np.savez)(path, **arrays)


def load_npz(path) -> CSR:
    """Load a CSR saved with :func:`save_npz`."""
    with np.load(path) as d:
        nrows, ncols = (int(x) for x in d["shape"])
        values = d["values"] if bool(d["has_values"]) else None
        return CSR(nrows, ncols, len(d["colinds"]), d["rowptrs"], d["colinds"], values)
