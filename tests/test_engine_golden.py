"""Engine golden-file tests against the reference's engineTest.json.

Counterpart of Testing::testEngineTesting (src/test/Testing.cu:340-477):
runs the factor step + disturbance elimination on the 3-tank / K=6
problem and compares every per-node factor matrix at one sampled node
per stage (the fixture's ``scenarioNodes``), at the reference tolerance
of 1e-2 absolute.

Matrix fixtures are flat column-major per node (cuBLAS layout); our
row-major tensors are transposed before comparison.
"""

import numpy as np
import pytest

from rapidnet_jax.io import jsonio
from tests.conftest import fixture_path, requires_reference

TOL = 1e-2


@pytest.fixture(scope="module")
def golden():
    return jsonio.load_json(fixture_path("engineTest.json"))


@pytest.fixture(scope="module")
def elim(ref_engine, ref_problem):
    """Factor step + elimination exactly as testEngineTesting does."""
    fc = ref_problem["forecaster"]
    cfg = ref_problem["config"]
    fc.predict_demand(1)
    fc.predict_prices(1)
    prev_uhat = (cfg.prev_demand @ ref_engine.Lhat.T).astype(np.float32)
    out = ref_engine.eliminate_input_disturbance_coupling(
        fc.nominal_demand, fc.nominal_prices, prev_uhat)
    return out


def _cmp_nodes(golden_flat, tensor, node_ids, transpose=True):
    """Compare row-major per-node matrices vs col-major fixture slices."""
    golden_flat = np.asarray(golden_flat, np.float32)
    dim = tensor[0].size
    for i, node in enumerate(node_ids):
        mine = tensor[node]
        mine = mine.T.reshape(-1) if (transpose and mine.ndim == 2) \
            else mine.reshape(-1)
        ref = golden_flat[i * dim:(i + 1) * dim]
        np.testing.assert_allclose(mine, ref, atol=TOL,
                                   err_msg=f"node {node} (sample {i})")


@requires_reference
def test_mat_l(ref_engine, golden):
    np.testing.assert_allclose(ref_engine.L.T.reshape(-1),
                               np.asarray(golden["matL"], np.float32),
                               atol=TOL)


@requires_reference
def test_uhat_e_beta_alpha(elim, golden):
    np.testing.assert_allclose(elim["uhat"].reshape(-1),
                               np.asarray(golden["uHat"], np.float32),
                               atol=TOL)
    np.testing.assert_allclose(elim["e"].reshape(-1),
                               np.asarray(golden["vecE"], np.float32),
                               atol=TOL)
    np.testing.assert_allclose(elim["alpha"].reshape(-1),
                               np.asarray(golden["costAlpha"], np.float32),
                               atol=TOL)
    np.testing.assert_allclose(elim["beta"].reshape(-1),
                               np.asarray(golden["beta"], np.float32),
                               atol=TOL)


@requires_reference
def test_preconditioned_bounds(ref_engine, golden, ref_problem):
    nodes = np.asarray(golden["scenarioNodes"], np.int64) - 1
    _cmp_nodes(golden["xmin"], ref_engine.xmin_node, nodes)
    _cmp_nodes(golden["xmax"], ref_engine.xmax_node, nodes)
    _cmp_nodes(golden["xs"], ref_engine.xs_node, nodes)
    _cmp_nodes(golden["umin"], ref_engine.umin_node, nodes)
    _cmp_nodes(golden["umax"], ref_engine.umax_node, nodes)


@requires_reference
def test_preconditioned_system_matrices(ref_engine, golden):
    """sysF (2nx x nx) / sysG (nu x nu) diagonal preconditioner blocks."""
    nodes = np.asarray(golden["scenarioNodes"], np.int64) - 1
    nx, nu = ref_engine.network.nx, ref_engine.network.nu
    n_nodes = ref_engine.tree.n_nodes
    sysF = np.zeros((n_nodes, 2 * nx, nx), np.float32)
    sysG = np.zeros((n_nodes, nu, nu), np.float32)
    idx = np.arange(nx)
    sysF[:, idx, idx] = ref_engine.d1_node
    sysF[:, nx + idx, idx] = ref_engine.d2_node
    iu = np.arange(nu)
    sysG[:, iu, iu] = ref_engine.g_node
    _cmp_nodes(golden["sysF"], sysF, nodes)
    _cmp_nodes(golden["sysG"], sysG, nodes)


@requires_reference
def test_factor_matrices(ref_engine, golden):
    t = ref_engine.factor_tensors_node_layout()
    nodes = np.asarray(golden["scenarioNodes"], np.int64) - 1
    fb_stage = ref_engine.tree.final_branch_stage
    # Omega / Theta / G compared only over the branching prefix
    # (Testing.cu passes idFinalBranchStage as arraySize)
    _cmp_nodes(golden["omega"], t["omega"], nodes[:fb_stage])
    _cmp_nodes(golden["Theta"], t["theta"], nodes[:fb_stage])
    _cmp_nodes(golden["g"], t["g"], nodes[:fb_stage])
    _cmp_nodes(golden["d"], t["d"], nodes)
    _cmp_nodes(golden["f"], t["f"], nodes)
    _cmp_nodes(golden["Phi"], t["phi"], nodes)
    _cmp_nodes(golden["Psi"], t["psi"], nodes)
    # Bbar is per-scenario (ns copies of L'B'); the fixture stores it
    # transposed relative to the other factor matrices
    _cmp_nodes(golden["Bbar"], t["Bbar"], np.arange(1), transpose=False)


def test_near_singular_costw_raises():
    """Conditioning guard on inv(L'WL) (reference checks LU `info` after
    the batched inverse, src/Engine.cu:1335-1353 — but only for exact
    singularity; we also reject hopeless-in-f32 conditioning)."""
    import dataclasses

    from rapidnet_jax.engine.engine import Engine
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree

    net = synthetic_network(nx=5, nu=8, nd=4, ne=2, seed=0)
    tree = generate_tree(N=6, branching=[2], nd=4, nu=8, seed=0)
    cfg = synthetic_config(net, tree, max_iterations=10)

    # well-conditioned costW passes
    Engine(net, tree, cfg)

    # costW with a ~1e-12 eigenvalue -> L'WL condition ~1e12
    W = 2.0 * np.eye(net.nu, dtype=np.float32)
    W[0, 0] = 2e-12
    W[1, 1] = 2e-12   # two tiny eigvals so some survive the projection
    W[2, 2] = 2e-12
    bad = dataclasses.replace(cfg, cost_w=W)
    with pytest.raises(ValueError, match="near-singular"):
        Engine(net, tree, bad)
