"""Smoke tests: the examples/ scripts run end-to-end (CPU)."""

import os
import subprocess
import sys

import pytest

from tests.conftest import REFERENCE_FIXTURES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *argv, timeout=420):
    env = dict(os.environ)
    # examples import rapidnet_jax; make them independent of whether
    # the editable install survived an environment reset
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cp = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *argv],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)
    assert cp.returncode == 0, cp.stderr[-2000:]
    return cp.stdout


@pytest.mark.skipif(not os.path.isdir(REFERENCE_FIXTURES),
                    reason="reference fixtures not available")
def test_closed_loop_reference_example():
    out = _run("closed_loop_reference_fixtures.py", "--platform", "cpu",
               "--steps", "2")
    assert "economic kpi" in out


def test_epanet_export_roundtrip_example(tmp_path):
    out = _run("epanet_to_controller.py", "--platform", "cpu",
               "--out", str(tmp_path / "dwn"))
    assert "KPIs:" in out
    assert (tmp_path / "dwn" / "controllerConfig.json").exists()


def test_multichip_sharded_example():
    out = _run("multichip_sharded.py", "--devices", "4",
               "--iterations", "40")
    assert "'scen': 4" in out
    assert "control u0:" in out


def test_batched_monte_carlo_example():
    out = _run("batched_monte_carlo.py", "--platform", "cpu",
               "--batch", "4", "--steps", "2", "--iterations", "40")
    assert "solves/s" in out and "OK" in out


@pytest.mark.skipif(not os.path.isdir(
    "/root/reference/src/paser/dataSource"),
    reason="reference dataSource unavailable")
def test_real_data_example():
    out = _run("real_data_closed_loop.py", "--problem", "dwn",
               "--steps", "2", "--iterations", "120",
               "--platform", "cpu")
    assert "economic kpi" in out
    out = _run("real_data_closed_loop.py", "--problem", "barcelona",
               "--steps", "1", "--iterations", "40",
               "--platform", "cpu")
    assert "network  kpi" in out


@pytest.mark.parametrize("algorithm,devices", [
    ("proximalAlgorithm", "0"), ("namaAlgorithm", "4")])
def test_large_tree_example(algorithm, devices):
    out = _run("large_tree.py", "--platform", "cpu", "--scenarios", "8",
               "--iters", "15", "--steps", "2", "--algorithm", algorithm,
               "--devices", devices)
    assert "economic KPI" in out
