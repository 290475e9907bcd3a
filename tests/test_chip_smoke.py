"""``chip_smoke.py``: its phases at a tiny size on the host, and its refusal
to report anything without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke

REPO = Path(__file__).resolve().parent.parent
TINY = dict(spmv_n=300, spmv_npr=7, spmm_n=128, spmm_density=0.05, spmm_k=8,
            esc_n=300, esc_npr=5)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def esc_below_300(monkeypatch):
    """A dense-intermediate budget that routes the 128-row products to the
    dense route and the 300-row ones to ESC, as the full sizes do."""
    from csr_tpu.ops import spgemm

    monkeypatch.setattr(spgemm, "max_dense_elems", 128 * 128)


def test_phase_spmv(rng, capsys):
    chip_smoke.phase_spmv(rng, TINY["spmv_n"], TINY["spmv_npr"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all("max_err=" in ln for ln in lines)
    assert "eff_GBps" not in lines[0]  # no device rate from a host run


def test_phase_spmm(rng):
    chip_smoke.phase_spmm(rng, TINY["spmm_n"], TINY["spmm_density"],
                          TINY["spmm_k"])


def test_phase_spgemm(rng, esc_below_300, capsys):
    chip_smoke.phase_spgemm(rng, TINY["spmm_n"], TINY["spmm_density"],
                            TINY["esc_n"], TINY["esc_npr"])
    out = capsys.readouterr().out
    assert out.count("matrix=dense/") == 2 and out.count("matrix=esc/") == 2


def test_phase_spgemm_route_mismatch(rng):
    """The ESC point must really take the ESC route."""
    with pytest.raises(AssertionError):
        chip_smoke.phase_spgemm(rng, 32, 0.1, 64, 4)


def test_phase_structure(rng):
    chip_smoke.phase_structure(rng, TINY["spmv_n"], TINY["spmv_npr"])


def test_phase_f64(rng, esc_below_300, capsys):
    chip_smoke.phase_f64(rng, TINY)
    assert capsys.readouterr().out.count("float64") == 7


def test_phase_multi(rng, capsys):
    chip_smoke.phase_multi(rng, 2, 64, 6, 4)
    assert capsys.readouterr().out.count("phase=multi") == len(chip_smoke.MESH_OPS)


def test_skewed_row_nnz(rng):
    counts = chip_smoke.skewed_row_nnz(rng, 1000, 20_000)
    assert counts.sum() == 20_000
    assert np.sort(counts)[::-1][:10].sum() == 10_000


def test_main_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def _run_script(cwd, env):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_script_fails_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = _run_script(REPO, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_script_fails_without_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run_script(tmp_path, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_phases_on_gpu(rng):
    """Device phase and SpMV phase on the card, with device rates."""
    from csr_tpu.utils.profiling import peak_hbm_bytes_per_s

    dev = chip_smoke.phase_device()
    chip_smoke.phase_spmv(rng, 4096, 32,
                          peak=peak_hbm_bytes_per_s(dev.device_kind))
