"""The measurement helpers: the peak table, the compile-cache location,
the byte model and the error bounds."""

from pathlib import Path

import numpy as np
import pytest
import jax
import scipy.sparse as sps

from csr_tpu.utils import compile_cache, tolerance
from csr_tpu.utils.profiling import (
    PEAK_HBM_BYTES_PER_S, csr_mult_bytes, peak_hbm_bytes_per_s,
)


def test_peak_h100():
    assert peak_hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert set(PEAK_HBM_BYTES_PER_S) == {"NVIDIA H100 80GB HBM3"}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H100"])
def test_peak_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no peak bandwidth"):
        peak_hbm_bytes_per_s(kind)


def test_csr_mult_bytes():
    # 8 B per entry, 4 B per row pointer, 4 B per operand and result value
    assert csr_mult_bytes(10, 20, 100) == 800 + 44 + 120
    assert csr_mult_bytes(10, 20, 100, k=3, value_bytes=8) == (
        100 * 12 + 44 + 30 * 3 * 8
    )


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, restore_cache_dir, tmp_path):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # left to JAX, which reads the variable itself: nothing set here
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path.endswith(".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert path == str(Path(__file__).resolve().parent.parent / ".jax_cache")


def test_bound_scales_with_mass():
    eps = np.finfo(np.float32).eps
    b = tolerance.bound([1.0, 0.0], [10.0, 1000.0], np.float32)
    np.testing.assert_allclose(b, [1e-4 + 320 * eps, 32000 * eps])
    b64 = tolerance.bound([1.0], [1.0], np.float64)
    np.testing.assert_allclose(b64, [1e-10 + 32 * np.finfo(np.float64).eps])


def test_check_rejects_and_reports():
    err, tol = tolerance.check([1.0, 2.0], [1.0, 2.0001], [1.0, 2.0],
                               np.float32)
    assert err == pytest.approx(1e-4) and tol > err
    with pytest.raises(AssertionError, match="out of bound"):
        tolerance.check([1.0, 2.1], [1.0, 2.0], [1.0, 2.0], np.float32)
    with pytest.raises(AssertionError, match="out of bound"):
        tolerance.check([np.nan], [0.0], [1.0], np.float32)
    with pytest.raises(AssertionError, match="shape"):
        tolerance.check([1.0], [1.0, 2.0], [1.0, 2.0], np.float32)


def test_check_sparse_structure():
    rng = np.random.default_rng(0)
    a = sps.random(40, 30, 0.2, format="csr", random_state=rng)
    b = sps.random(30, 20, 0.2, format="csr", random_state=rng)
    ref = (a @ b).tocsr()
    ref.sum_duplicates()
    mass = abs(a) @ abs(b)
    out = ref.astype(np.float32).tocsr()
    assert tolerance.check_sparse(out, ref, mass, np.float32)[2] == 0

    # an entry that cancels to zero on one side only is accepted when its
    # reference value is within the bound, and counted
    tiny = ref.copy()
    tiny.data[0] = 1e-9
    dropped = out.copy()
    dropped.data[0] = 0
    dropped.eliminate_zeros()
    assert tolerance.check_sparse(dropped, tiny, mass, np.float32)[2] == 1

    # a real entry missing from the result is not
    with pytest.raises(AssertionError, match="out of bound"):
        tolerance.check_sparse(dropped, ref, mass, np.float32)
