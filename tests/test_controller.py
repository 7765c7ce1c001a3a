"""Closed-loop controller tests (reference main.cu:34-69 semantics)."""

import copy

import numpy as np
import pytest

from tests.conftest import fixture_path, requires_reference


@requires_reference
def test_closed_loop_reference_problem(ref_problem, tmp_path):
    from rapidnet_jax.solver.controller import SmpcController
    cfg = copy.deepcopy(ref_problem["config"])
    cfg.max_iterations = 80   # short budget keeps the test fast
    ctrl = SmpcController(cfg, network=ref_problem["network"],
                          tree=ref_problem["tree"],
                          forecaster=ref_problem["forecaster"])
    out = tmp_path / "control.json"
    log = ctrl.closed_loop(steps=3, output_json=str(out))
    assert out.exists()
    for t in range(3):
        u = np.asarray(log[f"control{t}"])
        assert u.shape == (6,)
        assert np.isfinite(u).all()
        assert log[f"time{t}"][0] > 0
    # state evolved and stayed finite
    assert np.isfinite(ctrl.config.current_x).all()
    assert not np.allclose(ctrl.config.current_x,
                           ref_problem["config"].current_x)
    # KPIs accumulate
    assert log["economicKpi"] > 0
    assert log["smoothKpi"] >= 0
    assert np.isfinite(log["networkKpi"])


def test_closed_loop_synthetic():
    """End-to-end on a generated problem (no reference files needed)."""
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.solver.controller import SmpcController

    net = synthetic_network(nx=5, nu=8, nd=3, ne=2, seed=7)
    tree = generate_tree(N=8, branching=[2, 2], nd=3, nu=8, seed=7)
    fc = synthetic_forecaster(N=8, nd=3, nu=8, sim_horizon=6, seed=7)
    cfg = synthetic_config(net, tree, max_iterations=60, step_size=1e-3)
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc)
    log = ctrl.closed_loop(steps=2)
    for t in range(2):
        u = np.asarray(log[f"control{t}"])
        assert np.isfinite(u).all()
    assert np.isfinite(ctrl.config.current_x).all()


def test_closed_loop_no_buffer_leaks(ref_problem):
    """Device analog of the reference's cudaMemGetInfo leak invariant
    (src/SmpcController.cu:1612-1624): live device-buffer census stays
    flat across warm solves."""
    from rapidnet_jax.solver.controller import SmpcController
    cfg = copy.deepcopy(ref_problem["config"])
    cfg.max_iterations = 60
    ctrl = SmpcController(cfg, network=ref_problem["network"],
                          tree=ref_problem["tree"],
                          forecaster=ref_problem["forecaster"])
    log = ctrl.closed_loop(3)
    assert "memoryLeakWarning" not in log, log["memoryLeakWarning"]


@requires_reference
@pytest.mark.parametrize("config_name", ["controllerFbeConfig.json",
                                         "controllerNamaConfig.json"])
def test_closed_loop_quasi_newton_configs(config_name, ref_problem,
                                          tmp_path):
    """Closed loop under the reference's FBE/NAMA controller configs
    (the reference runs three suites per algorithm,
    src/test/Testing.cu:482-595)."""
    from rapidnet_jax.model.config import SmpcConfig
    from rapidnet_jax.solver.controller import SmpcController
    cfg = SmpcConfig.from_json(fixture_path(config_name))
    cfg.max_iterations = 30
    ctrl = SmpcController(cfg, network=ref_problem["network"],
                          tree=ref_problem["tree"],
                          forecaster=ref_problem["forecaster"])
    log = ctrl.closed_loop(2, output_json=str(tmp_path / "out.json"))
    for t in range(2):
        u = np.asarray(log[f"control{t}"])
        assert u.shape == (6,) and np.isfinite(u).all()
    assert np.isfinite(log["economicKpi"])


@requires_reference
def test_closed_loop_golden_trajectory(ref_problem):
    """Pin the end-to-end closed loop against a checked-in golden
    trajectory (reference-config APG, built-in simulator, 4 steps) so
    controller/engine plumbing refactors can't drift silently
    (reference closed loop: src/main.cu:45-69).  Regenerate with
    tests/golden/regen_closed_loop_apg.py if a numerics change is
    intentional.
    """
    import json
    import os

    from rapidnet_jax.solver.controller import SmpcController
    gpath = os.path.join(os.path.dirname(__file__), "golden",
                         "closed_loop_apg.json")
    with open(gpath) as f:
        golden = json.load(f)
    cfg = copy.deepcopy(ref_problem["config"])
    cfg.max_iterations = golden["max_iterations"]
    fc = copy.deepcopy(ref_problem["forecaster"])
    ctrl = SmpcController(cfg, network=ref_problem["network"],
                          tree=ref_problem["tree"], forecaster=fc)
    log = ctrl.closed_loop(steps=golden["steps"])
    for t in range(golden["steps"]):
        u = np.asarray(log[f"control{t}"], np.float32)
        g = np.asarray(golden["controls"][t], np.float32)
        np.testing.assert_allclose(
            u, g, rtol=1e-4, atol=1e-3 * max(np.abs(g).max(), 1.0),
            err_msg=f"control{t}")
    for kpi in ("economicKpi", "smoothKpi", "safetyKpi", "networkKpi"):
        np.testing.assert_allclose(log[kpi], golden[kpi], rtol=1e-3,
                                   atol=1e-6, err_msg=kpi)
    np.testing.assert_allclose(
        np.asarray(ctrl.config.current_x, np.float32),
        np.asarray(golden["final_state"], np.float32), rtol=1e-4,
        atol=1e-3)
