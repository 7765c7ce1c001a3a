"""Component tests of the data layer against the reference fixtures.

Counterpart of the reference's Testing::testNetwork / testScenarioTree /
testForecaster / testControllerConfig (src/test/Testing.cu:78-335).
"""

import numpy as np
import pytest

from tests.conftest import fixture_path, requires_reference


@requires_reference
def test_network_parse(ref_problem):
    net = ref_problem["network"]
    assert (net.nx, net.nu, net.nd, net.ne) == (3, 6, 4, 2)
    assert np.allclose(net.matA, np.eye(3))
    # column-major decode check: B column 2 (0-based) pushes tank 2
    assert net.matB.shape == (3, 6)
    assert net.matB[2, 2] == 1.0 and net.matB[0, 3] == 1.0
    assert net.xmax.tolist() == [470.0, 960.0, 3100.0]
    assert net.alpha1[0] == pytest.approx(0.1237)
    net.validate()


@requires_reference
def test_tree_parse_and_fan_layout(ref_problem):
    tree = ref_problem["tree"]
    assert tree.N == 24 and tree.ns == 6 and tree.n_nodes == 136
    assert tree.final_branch_stage == 2
    assert tree.final_branch_node == 10
    # ancestors converted to 0-based
    assert tree.ancestor[0] == -1
    assert tree.ancestor[1] == 0 and tree.ancestor[4] == 1
    # node probabilities sum to one per stage
    for s in range(tree.N):
        nodes = np.flatnonzero(tree.stage == s)
        assert tree.prob[nodes].sum() == pytest.approx(1.0, abs=1e-5)
    # fan layout: stage 0 all slots are the root; leaf stage is 1:1
    assert (tree.node_of_slot[0] == 0).all()
    assert sorted(tree.node_of_slot[-1].tolist()) == \
        sorted(tree.leaves.tolist())
    # rep counts = nodes per stage
    assert (tree.rep.sum(axis=1) == tree.nodes_per_stage).all()
    # gather/scatter round trip
    vals = np.random.default_rng(0).standard_normal(
        (tree.n_nodes, 3)).astype(np.float32)
    fan = tree.gather_to_fan(vals)
    back = tree.scatter_from_fan(fan)
    np.testing.assert_allclose(back, vals)
    # aggregation matrices: C_s @ ones(rep) counts children per parent slot
    for s, C in tree.prefix_agg.items():
        ones = tree.rep[s][:, None]
        counts = (C @ ones)[:, 0]
        # every stage-(s-1) node has >= 1 child; duplicated slots share it
        assert (counts >= 1).all()


@requires_reference
def test_forecaster_parse(ref_problem):
    fc = ref_problem["forecaster"]
    assert fc.N == 24 and fc.dim_demand == 4 and fc.dim_prices == 6
    assert fc.predict_demand(1)
    assert fc.predict_prices(1)
    assert fc.nominal_demand.shape == (24, 4)
    assert fc.nominal_prices.shape == (24, 6)
    assert np.isfinite(fc.nominal_demand).all()


@requires_reference
def test_config_parse(ref_problem):
    cfg = ref_problem["config"]
    assert (cfg.nx, cfg.nu, cfg.nd, cfg.nv, cfg.N) == (3, 6, 4, 4, 24)
    assert cfg.step_size == pytest.approx(1e-4)
    assert cfg.max_iterations == 500
    assert cfg.penalty_state == pytest.approx(1e6)
    assert cfg.penalty_safety == pytest.approx(1e4)
    assert cfg.mat_l.shape == (6, 4)
    assert cfg.mat_lhat.shape == (6, 4)
    assert cfg.diag_precnd.shape == (24, 12)
    assert cfg.algorithm == "proximalAlgorithm"
    # resolved relative paths must exist
    import os
    assert os.path.exists(cfg.path_to_network)
    assert os.path.exists(cfg.path_to_scenario_tree)
    assert os.path.exists(cfg.path_to_forecaster)


@requires_reference
def test_nullspace_properties(ref_problem):
    from rapidnet_jax.engine.nullspace import (nullspace_elimination,
                                               validate_nullspace)
    net = ref_problem["network"]
    L, Lhat = nullspace_elimination(net.matE, net.matEd)
    assert L.shape == (6, 4)
    validate_nullspace(net.matE, net.matEd, L, Lhat)
    # orthonormal basis
    np.testing.assert_allclose(L.T @ L, np.eye(4), atol=1e-5)
    # the config-provided Lhat must match the recomputed one (it is
    # unique); L may differ by an orthogonal rotation of the null space.
    cfg = ref_problem["config"]
    np.testing.assert_allclose(Lhat, cfg.mat_lhat, atol=1e-5)
    # config L spans the same null space: E @ L_cfg == 0
    validate_nullspace(net.matE, net.matEd, cfg.mat_l, cfg.mat_lhat)


def test_synthetic_tree_generator():
    from rapidnet_jax.model.scenario_tree import generate_tree
    tree = generate_tree(N=12, branching=[2, 2, 2], nd=4, nu=6, seed=1)
    assert tree.ns == 8
    assert tree.n_nodes == 1 + 2 + 4 + 8 * 9
    assert tree.final_branch_stage == 3
    for s in range(tree.N):
        nodes = np.flatnonzero(tree.stage == s)
        assert tree.prob[nodes].sum() == pytest.approx(1.0, abs=1e-5)
    assert set(tree.prefix_agg.keys()) == {1, 2, 3}


def test_tree_from_samples():
    """Forecaster-driven scenario generation (stagewise clustering)."""
    from rapidnet_jax.model.scenario_tree import generate_tree_from_samples
    rng = np.random.default_rng(0)
    d = np.cumsum(rng.standard_normal((100, 10, 4)) * 0.05,
                  axis=1).astype(np.float32)
    p = np.cumsum(rng.standard_normal((100, 10, 6)) * 0.02,
                  axis=1).astype(np.float32)
    tree = generate_tree_from_samples(d, p, branching=[3, 2])
    assert tree.ns <= 6 and tree.ns >= 2
    for s in range(tree.N):
        nodes = np.flatnonzero(tree.stage == s)
        assert tree.prob[nodes].sum() == pytest.approx(1.0, abs=1e-5)
    # node error values are within the sampled range
    assert np.abs(tree.err_demand).max() <= np.abs(d).max() + 1e-6


def test_synthetic_network_wellposed():
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.engine.nullspace import (nullspace_elimination,
                                               validate_nullspace)
    net = synthetic_network(nx=10, nu=20, nd=6, ne=4, seed=3)
    net.validate()
    L, Lhat = nullspace_elimination(net.matE, net.matEd)
    validate_nullspace(net.matE, net.matEd, L, Lhat)


def test_prefix_agg_factored_form():
    """C_s == Bp_s @ Cp_s exactly (the sharded solve's factored
    child->parent aggregation over distinct parents)."""
    from rapidnet_jax.model.scenario_tree import generate_tree
    tree = generate_tree(N=8, branching=[3, 2, 2], nd=4, nu=6, seed=5)
    assert set(tree.prefix_Cp) == set(tree.prefix_agg)
    for s, C in tree.prefix_agg.items():
        Cp, Bp = tree.prefix_Cp[s], tree.prefix_Bp[s]
        Rp = int(tree.nodes_per_stage[s - 1])
        assert Cp.shape == (Rp, tree.ns) and Bp.shape == (tree.ns, Rp)
        np.testing.assert_array_equal(Bp @ Cp, C)
        # each representative child slot feeds exactly one parent
        np.testing.assert_array_equal(Cp.sum(0), tree.rep[s])
        np.testing.assert_array_equal(Bp.sum(1), np.ones(tree.ns))
