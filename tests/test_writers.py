"""Round-trip tests for the reference-format JSON writers."""

import numpy as np
import pytest


def test_problem_export_roundtrip(tmp_path):
    from rapidnet_jax.model.network import synthetic_network, DwnNetwork
    from rapidnet_jax.model.scenario_tree import (ScenarioTree,
                                                  generate_tree)
    from rapidnet_jax.model.forecaster import (JsonForecaster,
                                               synthetic_forecaster)
    from rapidnet_jax.model.config import SmpcConfig, synthetic_config
    from rapidnet_jax.io.writers import export_problem
    from rapidnet_jax.engine.nullspace import nullspace_elimination

    net = synthetic_network(nx=5, nu=8, nd=3, ne=2, seed=1)
    tree = generate_tree(N=8, branching=[2, 2], nd=3, nu=8, seed=1)
    fc = synthetic_forecaster(N=8, nd=3, nu=8, sim_horizon=4, seed=1)
    cfg = synthetic_config(net, tree, max_iterations=50)
    L, Lhat = nullspace_elimination(net.matE, net.matEd)

    paths = export_problem(net, tree, fc, cfg, str(tmp_path),
                           mat_l=L, mat_lhat=Lhat)

    net2 = DwnNetwork.from_json(paths["network"])
    np.testing.assert_allclose(net2.matB, net.matB, rtol=1e-6)
    np.testing.assert_allclose(net2.matE, net.matE, rtol=1e-6)
    np.testing.assert_allclose(net2.xmax, net.xmax, rtol=1e-6)

    tree2 = ScenarioTree.from_json(paths["tree"])
    assert tree2.n_nodes == tree.n_nodes
    np.testing.assert_array_equal(tree2.ancestor, tree.ancestor)
    np.testing.assert_array_equal(tree2.node_of_slot, tree.node_of_slot)
    np.testing.assert_allclose(tree2.prob, tree.prob, rtol=1e-6)
    np.testing.assert_allclose(tree2.err_demand, tree.err_demand,
                               rtol=1e-5, atol=1e-6)

    fc2 = JsonForecaster(paths["forecaster"])
    fc.predict_demand(2)
    fc2.predict_demand(2)
    np.testing.assert_allclose(fc2.nominal_demand, fc.nominal_demand,
                               rtol=1e-5, atol=1e-6)

    cfg2 = SmpcConfig.from_json(paths["config"])
    assert cfg2.max_iterations == cfg.max_iterations
    np.testing.assert_allclose(cfg2.mat_l, L, rtol=1e-6)
    np.testing.assert_allclose(cfg2.cost_w, cfg.cost_w, rtol=1e-6)
    # the exported config is fully loadable by the controller
    from rapidnet_jax.solver.controller import SmpcController
    ctrl = SmpcController(paths["config"])
    u = ctrl.control_action(0)
    assert np.isfinite(u).all()
