"""Multi-device tests on the virtual 8-device CPU mesh.

Validates that the scenario-axis-sharded solve produces the same results
as the single-device path (SURVEY §4: the reference has no distributed
tests; this tier is new).
"""

import jax
import numpy as np
import pytest

from rapidnet_jax.engine.engine import XS_UPPER, Engine
from rapidnet_jax.model.config import synthetic_config
from rapidnet_jax.model.forecaster import synthetic_forecaster
from rapidnet_jax.model.network import synthetic_network
from rapidnet_jax.model.scenario_tree import generate_tree
from rapidnet_jax.solver import apg as apg_mod
from rapidnet_jax.solver.controller import _factor_arrays, _step_arrays


@pytest.fixture(scope="module")
def problem():
    """Synthetic problem with ns=16 scenarios (divisible by 8 devices)."""
    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=11)
    tree = generate_tree(N=10, branching=[4, 2, 2], nd=3, nu=7, seed=11)
    assert tree.ns == 16
    fc = synthetic_forecaster(N=10, nd=3, nu=7, sim_horizon=4, seed=11)
    cfg = synthetic_config(net, tree, max_iterations=40, step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = _factor_arrays(eng)
    step = _step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, cfg.current_x, cfg.prev_u,
        cfg.prev_demand))
    return dict(cfg=cfg, eng=eng, fa=fa, step=step,
                prefix_stages=eng.factor_step().prefix_stages)


def _solver_kwargs(p):
    cfg = p["cfg"]
    return dict(prefix_stages=p["prefix_stages"],
                inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
                penalty_state=cfg.penalty_state,
                penalty_safety=cfg.penalty_safety,
                xs_upper=float(XS_UPPER),
                max_iterations=cfg.max_iterations)


def test_sharded_apg_matches_single_device(problem):
    from rapidnet_jax.parallel import (make_mesh, make_sharded_apg,
                                       shard_factor_arrays,
                                       shard_step_arrays)
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"

    single = jax.jit(apg_mod.make_apg(**_solver_kwargs(problem)))
    ref = single(problem["fa"], problem["step"])

    mesh = make_mesh(8)
    fa_sh = shard_factor_arrays(problem["fa"], mesh)
    step_sh = shard_step_arrays(problem["step"], mesh)
    sharded = make_sharded_apg(mesh, problem["fa"], problem["step"],
                               **_solver_kwargs(problem))
    out = sharded(fa_sh, step_sh)

    np.testing.assert_allclose(np.asarray(out["control"]),
                               np.asarray(ref["control"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out["u"]), np.asarray(ref["u"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out["x"]), np.asarray(ref["x"]),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(
        np.asarray(out["primal_infeasibility"]),
        np.asarray(ref["primal_infeasibility"]), rtol=1e-3, atol=1e-4)


def test_sharded_apg_4_devices(problem):
    """Mesh sizes that do not equal the scenario count also work."""
    from rapidnet_jax.parallel import (make_mesh, make_sharded_apg,
                                       shard_factor_arrays,
                                       shard_step_arrays)
    mesh = make_mesh(4)
    fa_sh = shard_factor_arrays(problem["fa"], mesh)
    step_sh = shard_step_arrays(problem["step"], mesh)
    sharded = make_sharded_apg(mesh, problem["fa"], problem["step"],
                               **_solver_kwargs(problem))
    out = sharded(fa_sh, step_sh)
    single = jax.jit(apg_mod.make_apg(**_solver_kwargs(problem)))
    ref = single(problem["fa"], problem["step"])
    np.testing.assert_allclose(np.asarray(out["control"]),
                               np.asarray(ref["control"]),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("algorithm", ["globalFbeAlgorithm",
                                       "namaAlgorithm"])
def test_sharded_quasi_newton_matches_single_device(problem, algorithm):
    from rapidnet_jax.parallel import (make_mesh,
                                       make_sharded_quasi_newton,
                                       shard_factor_arrays,
                                       shard_step_arrays)
    from rapidnet_jax.solver import quasi_newton

    kw = dict(_solver_kwargs(problem), max_iterations=15,
              lbfgs_buffer_size=4)
    single = jax.jit(quasi_newton.make_solver(algorithm=algorithm, **kw))
    ref = single(problem["fa"], problem["step"])

    mesh = make_mesh(8)
    fa_sh = shard_factor_arrays(problem["fa"], mesh)
    step_sh = shard_step_arrays(problem["step"], mesh)
    sharded = make_sharded_quasi_newton(
        mesh, problem["fa"], problem["step"], algorithm=algorithm, **kw)
    out = sharded(fa_sh, step_sh)

    np.testing.assert_allclose(np.asarray(out["control"]),
                               np.asarray(ref["control"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out["u"]), np.asarray(ref["u"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(out["value_fbe"]), np.asarray(ref["value_fbe"]),
        rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(out["tau"]), np.asarray(ref["tau"]),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_devices", [2, 4])
@pytest.mark.parametrize("algorithm", ["globalFbeAlgorithm",
                                       "namaAlgorithm"])
def test_sharded_quasi_newton_small_meshes(problem, algorithm, n_devices):
    """FBE/NAMA over 2- and 4-device meshes (the 4-GPU layout) equal the
    single-device solve: control, L-BFGS line-search taus."""
    from rapidnet_jax.parallel import (make_mesh,
                                       make_sharded_quasi_newton,
                                       shard_factor_arrays,
                                       shard_step_arrays)
    from rapidnet_jax.solver import quasi_newton

    kw = dict(_solver_kwargs(problem), max_iterations=15,
              lbfgs_buffer_size=4)
    ref = jax.jit(quasi_newton.make_solver(algorithm=algorithm, **kw))(
        problem["fa"], problem["step"])
    mesh = make_mesh(n_devices)
    out = make_sharded_quasi_newton(
        mesh, problem["fa"], problem["step"], algorithm=algorithm, **kw)(
        shard_factor_arrays(problem["fa"], mesh),
        shard_step_arrays(problem["step"], mesh))
    np.testing.assert_allclose(np.asarray(out["control"]),
                               np.asarray(ref["control"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out["tau"]),
                               np.asarray(ref["tau"]), rtol=1e-4, atol=1e-5)


def test_2d_mesh_batched_sharded_apg(problem):
    """dp x sp: (batch, scen) 2-D mesh matches per-instance solves."""
    import jax.numpy as jnp
    from rapidnet_jax.parallel import (make_mesh_2d, make_sharded_apg_batch,
                                       shard_factor_arrays,
                                       shard_step_arrays_batch)

    B = 4
    rng = np.random.default_rng(5)
    x0 = problem["cfg"].current_x
    steps = []
    eng, cfg, fc = problem["eng"], problem["cfg"], None
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    fc = synthetic_forecaster(N=10, nd=3, nu=7, sim_horizon=4, seed=11)
    fc.predict_demand(0)
    fc.predict_prices(0)
    from rapidnet_jax.solver.controller import _step_arrays
    for b in range(B):
        xr = (x0 * (0.9 + 0.2 * rng.random(x0.shape))).astype(np.float32)
        steps.append(_step_arrays(eng.prepare_step(
            fc.nominal_demand, fc.nominal_prices, xr, cfg.prev_u,
            cfg.prev_demand)))
    batched = {k: jnp.stack([s[k] for s in steps]) for k in steps[0]}

    mesh = make_mesh_2d(2, 4)
    fa_sh = shard_factor_arrays(problem["fa"], mesh)
    steps_sh = shard_step_arrays_batch(batched, mesh)
    fn = make_sharded_apg_batch(mesh, problem["fa"], steps[0],
                                **_solver_kwargs(problem))
    out = fn(fa_sh, steps_sh)

    single = jax.jit(apg_mod.make_apg(**_solver_kwargs(problem)))
    for b, step in enumerate(steps):
        ref = single(problem["fa"], step)
        np.testing.assert_allclose(np.asarray(out["control"])[b],
                                   np.asarray(ref["control"]),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(
            np.asarray(out["primal_infeasibility"])[b],
            np.asarray(ref["primal_infeasibility"]), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("algorithm", ["proximalAlgorithm",
                                       "globalFbeAlgorithm"])
def test_controller_sharded_closed_loop(algorithm):
    """SmpcController(mesh=...) runs the closed loop sharded and matches
    the single-device controller."""
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.parallel import make_mesh
    from rapidnet_jax.solver.controller import SmpcController

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=21)
    tree = generate_tree(N=8, branching=[4, 2], nd=3, nu=7, seed=21)
    # FBE's backtracking line search takes hard branches on global dots,
    # so f32 psum-order differences can flip a tau choice and diverge
    # the trajectories; keep its budget short (the sub-step equivalence
    # is covered tightly by test_sharded_quasi_newton_matches_...)
    iters = 20 if algorithm == "proximalAlgorithm" else 10

    def build(mesh):
        cfg = synthetic_config(net, tree, max_iterations=iters,
                               step_size=1e-3, algorithm=algorithm)
        fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=5, seed=21)
        return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                              mesh=mesh)

    log_ref = build(None).closed_loop(3)
    log_sh = build(make_mesh(8)).closed_loop(3)
    for t in range(3):
        np.testing.assert_allclose(np.asarray(log_sh[f"control{t}"]),
                                   np.asarray(log_ref[f"control{t}"]),
                                   rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(log_sh["economicKpi"],
                               log_ref["economicKpi"], rtol=1e-3,
                               atol=1e-9)


def test_sharded_warm_start_and_tolerance(problem):
    """Warm start + early termination on the sharded path: fewer
    iterations to tolerance, same control (the reference always
    cold-starts, src/SmpcController.cu:425-432)."""
    from rapidnet_jax.parallel import (make_mesh, make_sharded_apg,
                                       shard_factor_arrays,
                                       shard_step_arrays)
    kw = dict(_solver_kwargs(problem), max_iterations=400, tolerance=5e-2)
    mesh = make_mesh(8)
    fa_sh = shard_factor_arrays(problem["fa"], mesh)
    step_sh = shard_step_arrays(problem["step"], mesh)
    fn = make_sharded_apg(mesh, problem["fa"], problem["step"], **kw)
    cold = fn(fa_sh, step_sh)            # y0 defaults to zeros
    it_cold = int(cold["iterations"])
    warm = fn(fa_sh, step_sh, cold["y"])
    it_warm = int(warm["iterations"])
    assert 0 < it_warm < it_cold, (it_warm, it_cold)
    np.testing.assert_allclose(np.asarray(warm["control"]),
                               np.asarray(cold["control"]),
                               rtol=5e-2, atol=5e-3)

    # matches the single-device solver at the same budget
    single = jax.jit(apg_mod.make_apg(**kw))
    ref = single(problem["fa"], problem["step"])
    assert abs(int(ref["iterations"]) - it_cold) <= 2, \
        (int(ref["iterations"]), it_cold)
    np.testing.assert_allclose(np.asarray(cold["control"]),
                               np.asarray(ref["control"]),
                               rtol=2e-4, atol=2e-4)


def test_controller_sharded_warm_closed_loop():
    """SmpcController(mesh, warm_start=True, tolerance=...) reduces
    closed-loop iterations vs the cold controller and tracks its
    controls."""
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.parallel import make_mesh
    from rapidnet_jax.solver.controller import SmpcController

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=21)
    tree = generate_tree(N=8, branching=[4, 2], nd=3, nu=7, seed=21)

    def build(warm):
        cfg = synthetic_config(net, tree, max_iterations=300,
                               step_size=1e-3)
        fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=5, seed=21)
        return SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                              mesh=make_mesh(8),
                              warm_start=warm, tolerance=5e-2)

    cold_ctrl, warm_ctrl = build(False), build(True)
    iters_cold, iters_warm = [], []
    for t in range(3):
        cold_ctrl.control_action(t)
        iters_cold.append(int(np.asarray(cold_ctrl._last["iterations"])))
        cold_ctrl.move_forward_in_time()
        u = warm_ctrl.control_action(t)
        iters_warm.append(int(np.asarray(warm_ctrl._last["iterations"])))
        warm_ctrl.move_forward_in_time()
        assert np.all(np.isfinite(u))
    # step 0 is identical (both cold); later steps must be cheaper warm
    assert iters_warm[0] == iters_cold[0]
    assert sum(iters_warm[1:]) < sum(iters_cold[1:]), (iters_warm,
                                                       iters_cold)
