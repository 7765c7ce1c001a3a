"""Auxiliary subsystem tests: EPANET parser, checkpoint, CLI, tuning,
external-simulator state contract."""

import json
import os

import numpy as np
import pytest

from tests.conftest import requires_reference

EPANET_SAMPLE = "/root/reference/src/paser/testEpanet.inp"


@pytest.mark.skipif(not os.path.exists(EPANET_SAMPLE),
                    reason="reference epanet sample not available")
def test_epanet_parser():
    from rapidnet_jax.io.epanet import parse_epanet
    net = parse_epanet(EPANET_SAMPLE)
    # testEpanet.inp: 3 tanks, 5 pumps + 0 valves, 3 junctions
    assert net.nx == 3 and net.nu == 5 and net.nd == 3
    # pump 19: 3 -> 2 (both tanks): +1 at tank '3', -1 at tank '2'
    tank_idx = {"2": 0, "3": 1, "4": 2}
    assert net.matB[tank_idx["3"], 0] == 1.0
    assert net.matB[tank_idx["2"], 0] == -1.0
    # junction 12 touches pumps 221, 222 (dest) and 223 (source)
    assert net.ne >= 1
    # mass-balance validation passes
    net.validate()
    # pipe 10 connects junction 10 to tank 2
    assert net.matGd[tank_idx["2"], 0] == 1.0


def _small_controller(max_iterations=30):
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.solver.controller import SmpcController

    net = synthetic_network(nx=4, nu=6, nd=3, ne=2, seed=3)
    tree = generate_tree(N=6, branching=[2], nd=3, nu=6, seed=3)
    fc = synthetic_forecaster(N=6, nd=3, nu=6, sim_horizon=8, seed=3)
    cfg = synthetic_config(net, tree, max_iterations=max_iterations,
                           step_size=1e-4)
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc)


def test_checkpoint_roundtrip(tmp_path):
    from rapidnet_jax.utils.checkpoint import (checkpoint_exists,
                                               load_checkpoint,
                                               save_checkpoint)
    ctrl = _small_controller()
    ctrl.control_action(0)
    ctrl.move_forward_in_time()
    path = str(tmp_path / "ckpt")
    save_checkpoint(ctrl, path, sim_time=1)
    assert checkpoint_exists(path)

    ctrl2 = _small_controller()
    t = load_checkpoint(ctrl2, path)
    assert t == 1
    np.testing.assert_allclose(ctrl2.config.current_x,
                               ctrl.config.current_x)
    assert ctrl2.economic_kpi_acc == ctrl.economic_kpi_acc


def test_external_simulator_contract(tmp_path):
    """State round-trips through the config JSON (simulatorFlag=0)."""
    from rapidnet_jax.io import jsonio
    ctrl = _small_controller()
    cfgpath = str(tmp_path / "cfg.json")
    jsonio.dump_json(cfgpath, {
        "currentX": ctrl.config.current_x,
        "prevU": ctrl.config.prev_u,
        "prevDemand": ctrl.config.prev_demand,
    })
    ctrl.config.path_to_config = cfgpath
    ctrl.simulator_flag = False
    ctrl.control_action(0)
    x = ctrl.move_forward_in_time()
    doc = jsonio.load_json(cfgpath)
    np.testing.assert_allclose(np.asarray(doc["currentX"], np.float32), x,
                               rtol=1e-6)
    # an external simulator can overwrite the state...
    doc["currentX"] = (np.asarray(doc["currentX"]) + 1.0).tolist()
    jsonio.dump_json(cfgpath, doc)
    ctrl.reload_state_from_config()
    np.testing.assert_allclose(ctrl.config.current_x, x + 1.0, rtol=1e-6)


def test_auto_tuning_converges():
    import copy
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.solver.controller import SmpcController
    from rapidnet_jax.solver.tuning import (auto_tune,
                                            estimate_dual_lipschitz)
    from rapidnet_jax.engine.engine import Engine

    net = synthetic_network(nx=6, nu=10, nd=4, ne=3, seed=9)
    tree = generate_tree(N=8, branching=[3], nd=4, nu=10, seed=9)
    cfg0 = synthetic_config(net, tree, max_iterations=150)
    cfg, eng = auto_tune(net, tree, cfg0)
    # preconditioning reduced the dual Lipschitz constant
    L0 = estimate_dual_lipschitz(Engine(net, tree, cfg0))
    L1 = estimate_dual_lipschitz(eng)
    assert L1 < L0
    assert cfg.step_size == pytest.approx(0.999 / L1, rel=0.3)

    fc = synthetic_forecaster(N=8, nd=4, nu=10, sim_horizon=4, seed=9)
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc)
    ctrl.control_action(0)
    infs = np.abs(ctrl.primal_infeasibility)
    assert infs[-10:].mean() < max(1e-2 * infs[:10].max(), 0.1)


def test_warm_start_and_tolerance():
    """Warm-started, tolerance-terminated closed loop uses fewer
    iterations after the first step (a capability the reference lacks —
    it always cold-starts the full budget)."""
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.solver.controller import SmpcController
    from rapidnet_jax.solver.tuning import auto_tune

    net = synthetic_network(nx=4, nu=6, nd=3, ne=2, seed=3)
    tree = generate_tree(N=6, branching=[2], nd=3, nu=6, seed=3)
    cfg0 = synthetic_config(net, tree, max_iterations=400)
    cfg, _ = auto_tune(net, tree, cfg0)
    fc = synthetic_forecaster(N=6, nd=3, nu=6, sim_horizon=8, seed=3)
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          warm_start=True, tolerance=1e-3)
    iters = []
    for t in range(3):
        ctrl.control_action(t)
        iters.append(int(np.asarray(ctrl._last["iterations"])))
        ctrl.move_forward_in_time()
    assert iters[0] <= 400
    # warm started steps terminate earlier than the cold start
    assert min(iters[1:]) <= iters[0]


def test_cli_runs(tmp_path, ref_problem):
    """CLI end-to-end on the reference config (2 steps, reduced budget)."""
    import shutil
    from rapidnet_jax.io import jsonio
    from tests.conftest import fixture_path
    # clone the config with a smaller iteration budget + local paths
    doc = jsonio.load_json(fixture_path("controllerConfig.json"))
    doc["maxIterations"] = [40]
    doc["pathToNetwork"] = fixture_path("network.json")
    doc["pathToScenarioTree"] = fixture_path("scenarioTree.json")
    doc["pathToForecaster"] = fixture_path("forecastor.json")
    cfgpath = str(tmp_path / "cfg.json")
    jsonio.dump_json(cfgpath, doc)

    from rapidnet_jax import cli
    out = str(tmp_path / "control.json")
    rc = cli.main(["--config", cfgpath, "--steps", "2", "--output", out])
    assert rc == 0
    log = json.load(open(out))
    assert "control0" in log and "time1" in log


@pytest.mark.parametrize("algorithm", ["proximalAlgorithm",
                                       "globalFbeAlgorithm",
                                       "namaAlgorithm"])
def test_checkpoint_warm_resume(tmp_path, algorithm):
    """A warm-start checkpoint restores the {xi, psi} dual carry, and the
    resumed controller's next solve equals the uninterrupted one."""
    import copy

    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.solver.controller import SmpcController
    from rapidnet_jax.utils.checkpoint import (load_checkpoint,
                                               save_checkpoint)

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=9)
    tree = generate_tree(N=6, branching=[2], nd=3, nu=7, seed=9)
    cfg = synthetic_config(net, tree, max_iterations=20, step_size=1e-3,
                           algorithm=algorithm)

    def controller():
        fc = synthetic_forecaster(N=6, nd=3, nu=7, sim_horizon=5, seed=9)
        return SmpcController(copy.deepcopy(cfg), network=net, tree=tree,
                              forecaster=fc, warm_start=True)

    ref = controller()
    ref.control_action(0)
    ref.move_forward_in_time()
    u_ref = ref.control_action(1)

    ctrl = controller()
    ctrl.control_action(0)
    ctrl.move_forward_in_time()
    path = str(tmp_path / "ckpt")
    save_checkpoint(ctrl, path, sim_time=1)

    resumed = controller()
    assert load_checkpoint(resumed, path) == 1
    assert set(resumed._y_carry) == {"xi", "psi"}
    u = resumed.control_action(1)
    np.testing.assert_allclose(u, u_ref, rtol=1e-6, atol=1e-6)
