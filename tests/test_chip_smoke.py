"""chip_smoke.py: each phase at a tiny size on the CPU, and its GPU guard.

The phases check their results themselves (``Report``); here every check
must pass.  The scipy entry point is pinned to the device routes, as it is
at the script's real sizes.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import scipy.sparse as sp

import sparse_matrix_mult_tpu as smm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.fixture
def device_routes():
    old = smm.get_config()
    smm.set_config(
        auto_calibrate_link=False, host_compute_limit=0, host_rate_base=1e3
    )
    yield
    smm.set_config(old)


def _run(phase, **sizes):
    report = chip_smoke.Report()
    phase(report, **sizes)
    assert report.failures == []


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_phase_env(capsys):
    chip_smoke.phase_env(chip_smoke.Report())
    out = capsys.readouterr().out
    for key in ("nvidia-smi --query-gpu", "device:", "jax ", "compile cache dir", "native host library"):
        assert key in out


def test_phase_headline(device_routes):
    _run(chip_smoke.phase_headline, n=80, density=0.1)


def test_phase_dense_output(device_routes):
    _run(chip_smoke.phase_dense_output, n=200, density=0.02)


def test_phase_triple(device_routes):
    _run(chip_smoke.phase_triple, m=90, n=70, density=0.05)


def test_phase_esc(device_routes):
    _run(chip_smoke.phase_esc, n=3000, nnz=9000, big_n=5000, big_nnz=20000)


def test_phase_triu():
    _run(chip_smoke.phase_triu, n=300, density=0.1)


def test_phase_four_on_four_cpu_devices():
    _run(
        chip_smoke.phase_four, devices=jax.devices()[:4], n=64, density=0.1,
        big_n=3000, big_nnz=9000, tri_m=60, tri_n=40, tri_density=0.05,
    )


def test_report_flags_host_route_and_error():
    report = chip_smoke.Report()
    ref = np.eye(3)
    assert report.check("t", "exact", ref.copy(), ref)
    assert not report.check("t", "host", ref.copy(), ref, route="host")
    assert not report.check("t", "off", ref + 1e-3, ref)
    assert len(report.failures) == 2


@pytest.mark.parametrize("same_structure", [True, False])
def test_compare_sparse(same_structure):
    ref = sp.random(40, 30, density=0.2, format="csr", random_state=1)
    got = ref.copy()
    if not same_structure:
        got = got + sp.csr_matrix(([1e-12], ([0], [0])), shape=ref.shape)
    _, _, ok = chip_smoke.compare(got, ref)
    assert ok
    bad = ref.copy()
    bad.data[0] *= 1.01
    assert not chip_smoke.compare(bad, ref)[2]
