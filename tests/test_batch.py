"""Batched solve and batched closed-loop tests (BASELINE config #5).

Batched paths must agree exactly (float32) with per-instance solves —
vmap adds a batch axis but must not change the math.
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
from rapidnet_jax.solver.batch import BatchedSmpcController
from rapidnet_jax.solver.controller import (SmpcController, _factor_arrays,
                                            _step_arrays)

B = 3


@pytest.fixture(scope="module")
def problem():
    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=3)
    tree = generate_tree(N=8, branching=[2, 2], nd=3, nu=7, seed=3)
    fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=6, seed=3)
    cfg = synthetic_config(net, tree, max_iterations=30, step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = _factor_arrays(eng)
    rng = np.random.default_rng(17)
    x0s = cfg.current_x * (0.9 + 0.2 * rng.random((B, cfg.current_x.size)))
    steps = [_step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, x0s[b].astype(np.float32),
        cfg.prev_u, cfg.prev_demand)) for b in range(B)]
    kw = dict(prefix_stages=eng.factor_step().prefix_stages,
              inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
              penalty_state=cfg.penalty_state,
              penalty_safety=cfg.penalty_safety,
              xs_upper=float(XS_UPPER), max_iterations=30)
    return dict(net=net, tree=tree, fc=fc, cfg=cfg, eng=eng, fa=fa,
                steps=steps, x0s=x0s.astype(np.float32), kw=kw)


def _stack(steps):
    import jax.numpy as jnp
    return {k: jnp.stack([s[k] for s in steps]) for k in steps[0]}


def test_batched_xla_matches_per_instance(problem):
    single = jax.jit(apg_mod.make_apg(**problem["kw"]))
    batched = jax.jit(apg_mod.make_apg_batch(**problem["kw"]))
    out_b = batched(problem["fa"], _stack(problem["steps"]))
    for b, step in enumerate(problem["steps"]):
        out_1 = single(problem["fa"], step)
        np.testing.assert_array_equal(np.asarray(out_b["control"])[b],
                                      np.asarray(out_1["control"]))
        np.testing.assert_array_equal(
            np.asarray(out_b["primal_infeasibility"])[b],
            np.asarray(out_1["primal_infeasibility"]))


def test_batched_closed_loop_matches_sequential(problem):
    cfg, net, tree = problem["cfg"], problem["net"], problem["tree"]
    x0s = problem["x0s"]

    def fresh_fc():
        return synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=6, seed=3)

    bctrl = BatchedSmpcController(cfg, net, tree, fresh_fc(), x0s)
    blog = bctrl.closed_loop(3)

    for b in range(B):
        cfg_b = cfg.replace(current_x=x0s[b]) if hasattr(cfg, "replace") \
            else None
        if cfg_b is None:
            import copy
            cfg_b = copy.deepcopy(cfg)
            cfg_b.set_current_state(x0s[b])
        ctrl = SmpcController(cfg_b, network=net, tree=tree,
                              forecaster=fresh_fc())
        log = ctrl.closed_loop(3)
        for t in range(3):
            np.testing.assert_allclose(
                blog["controls"][t, b], np.asarray(log[f"control{t}"]),
                rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(blog["economicKpi"][b],
                                   log["economicKpi"], rtol=1e-5)
        np.testing.assert_allclose(blog["smoothKpi"][b],
                                   log["smoothKpi"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(blog["safetyKpi"][b],
                                   log["safetyKpi"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(blog["networkKpi"][b],
                                   log["networkKpi"], rtol=1e-5)


def test_batched_warm_start_runs(problem):
    cfg, net, tree = problem["cfg"], problem["net"], problem["tree"]
    fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=6, seed=3)
    bctrl = BatchedSmpcController(cfg, net, tree, fc, problem["x0s"],
                                  warm_start=True)
    log = bctrl.closed_loop(2)
    assert log["controls"].shape == (2, B, 7)
    assert np.all(np.isfinite(log["controls"]))


def test_prepare_step_batch_matches_per_instance(problem):
    """Engine.prepare_step_batch (shared forecast + root correction)
    equals B independent prepare_step calls."""
    eng, cfg, fc = problem["eng"], problem["cfg"], problem["fc"]
    rng = np.random.default_rng(23)
    x0s = (cfg.current_x *
           (0.9 + 0.2 * rng.random((B, cfg.current_x.size)))
           ).astype(np.float32)
    prev_us = np.tile(cfg.prev_u, (B, 1)).astype(np.float32)
    prev_us *= (0.95 + 0.1 * rng.random(prev_us.shape)).astype(np.float32)
    prev_ds = np.tile(cfg.prev_demand, (B, 1)).astype(np.float32)
    prev_ds *= (0.95 + 0.1 * rng.random(prev_ds.shape)).astype(np.float32)

    batched = eng.prepare_step_batch(
        fc.nominal_demand, fc.nominal_prices, x0s, prev_us, prev_ds)
    for b in range(B):
        single = eng.prepare_step(fc.nominal_demand, fc.nominal_prices,
                                  x0s[b], prev_us[b], prev_ds[b])
        np.testing.assert_allclose(batched["beta"][b], single.beta,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(batched["uhat"][b], single.uhat)
        np.testing.assert_array_equal(batched["e"][b], single.e)
        np.testing.assert_allclose(batched["prev_uhat"][b],
                                   single.prev_uhat, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(batched["x0"][b], single.x0)


def test_batched_closed_loop_shared_forecaster_fast_path(problem):
    """Shared-forecaster batched loop (prepare_step_batch path) matches
    the per-instance-forecaster loop given identical forecasts."""
    cfg, net, tree = problem["cfg"], problem["net"], problem["tree"]
    x0s = problem["x0s"]

    def fc():
        return synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=6, seed=3)

    shared = BatchedSmpcController(cfg, net, tree, fc(), x0s)
    assert shared._shared_forecast
    per = BatchedSmpcController(cfg, net, tree, [fc() for _ in range(B)],
                                x0s)
    assert not per._shared_forecast
    log_a = shared.closed_loop(3)
    log_b = per.closed_loop(3)
    np.testing.assert_allclose(log_a["controls"], log_b["controls"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(log_a["economicKpi"], log_b["economicKpi"],
                               rtol=1e-4, atol=1e-9)


def test_batched_closed_loop_2d_mesh_matches_unsharded(problem):
    """BatchedSmpcController on a (batch, scen) 2-D mesh == unsharded."""
    from rapidnet_jax.parallel import make_mesh_2d
    cfg, net, tree = problem["cfg"], problem["net"], problem["tree"]
    # ns=4 scenarios, B=4 instances -> (2, 4) mesh on 8 virtual devices
    x0s = np.vstack([problem["x0s"], problem["x0s"][:1]])
    assert x0s.shape[0] == 4

    def fc():
        return synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=6, seed=3)

    ref = BatchedSmpcController(cfg, net, tree, fc(), x0s).closed_loop(3)
    sh = BatchedSmpcController(cfg, net, tree, fc(), x0s,
                               mesh=make_mesh_2d(2, 4)).closed_loop(3)
    np.testing.assert_allclose(sh["controls"], ref["controls"],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(sh["economicKpi"], ref["economicKpi"],
                               rtol=1e-4, atol=1e-9)


def test_stage_scan_path_matches_cumsum_path(problem, monkeypatch):
    """The large-ns sequential-scan sweeps (SCAN_MIN_NS) produce the
    same solve as the cumsum sweeps."""
    from rapidnet_jax.solver import solve_step as ss
    kw = problem["kw"]
    step = problem["steps"][0]

    monkeypatch.setattr(ss, "SCAN_MIN_NS", 1 << 30)
    ref = jax.jit(apg_mod.make_apg(**kw))(problem["fa"], step)
    ref = jax.tree.map(np.asarray, ref)

    monkeypatch.setattr(ss, "SCAN_MIN_NS", 1)
    got = jax.jit(apg_mod.make_apg(**kw))(problem["fa"], step)

    np.testing.assert_allclose(np.asarray(got["control"]), ref["control"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got["x"]), ref["x"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(got["primal_infeasibility"]),
        ref["primal_infeasibility"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("algorithm", ["globalFbeAlgorithm",
                                       "namaAlgorithm"])
def test_batched_quasi_newton_matches_per_instance(problem, algorithm):
    """vmapped FBE/NAMA solves track standalone solves (line searches
    run in masked lockstep under vmap -> f32-level trajectory drift)."""
    from rapidnet_jax.solver import quasi_newton
    kw = dict({k: v for k, v in problem["kw"].items()
               if k != "max_iterations"},
              max_iterations=15, lbfgs_buffer_size=4,
              algorithm=algorithm)
    single = jax.jit(quasi_newton.make_solver(**kw))
    batched = jax.jit(quasi_newton.make_solver_batch(**kw))
    out_b = batched(problem["fa"], _stack(problem["steps"]))
    for b, step in enumerate(problem["steps"]):
        ref = single(problem["fa"], step)
        np.testing.assert_allclose(np.asarray(out_b["control"])[b],
                                   np.asarray(ref["control"]),
                                   rtol=1e-2, atol=2e-3)


@pytest.mark.parametrize("algorithm", ["globalFbeAlgorithm",
                                       "namaAlgorithm"])
def test_batched_closed_loop_quasi_newton_matches_sequential(problem,
                                                             algorithm):
    """BatchedSmpcController runs FBE/NAMA closed loops (the reference
    treats all three algorithms uniformly behind one dispatch,
    src/SmpcController.cu:63-71).

    Identical lanes must match a standalone SmpcController tightly
    (pins the batched plumbing: shared-base assembly, KPI tracking,
    state advance).  Distinct lanes only get sanity checks: the
    masked-lockstep line searches under vmap can take different tau
    branches when an f32 comparison flips, so distinct-lane
    trajectories legitimately drift from standalone solves."""
    import copy
    import dataclasses
    cfg = dataclasses.replace(problem["cfg"], algorithm=algorithm,
                              max_iterations=25)
    net, tree = problem["net"], problem["tree"]

    def fresh_fc():
        return synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=6, seed=3)

    # --- identical lanes == sequential controller ---
    x0 = problem["x0s"][0]
    same = np.tile(x0, (B, 1))
    bctrl = BatchedSmpcController(cfg, net, tree, fresh_fc(), same)
    blog = bctrl.closed_loop(3)
    cfg_b = copy.deepcopy(cfg)
    cfg_b.set_current_state(x0)
    ctrl = SmpcController(cfg_b, network=net, tree=tree,
                          forecaster=fresh_fc())
    log = ctrl.closed_loop(3)
    for t in range(3):
        # lanes are identical data in one program -> bitwise equal
        for b in range(1, B):
            np.testing.assert_array_equal(blog["controls"][t, b],
                                          blog["controls"][t, 0])
        # vs the standalone controller: vmapped matmul layouts
        # reassociate f32 reductions, which can flip one line-search
        # branch -> small but real trajectory offsets
        np.testing.assert_allclose(
            blog["controls"][t, 0], np.asarray(log[f"control{t}"]),
            rtol=6e-2, atol=5e-3)
    np.testing.assert_allclose(blog["economicKpi"],
                               np.full(B, log["economicKpi"]), rtol=2e-2)

    # --- distinct lanes: finite, in-bounds, per-lane KPIs ---
    bctrl2 = BatchedSmpcController(cfg, net, tree, fresh_fc(),
                                   problem["x0s"])
    blog2 = bctrl2.closed_loop(2)
    assert blog2["controls"].shape == (2, B, 7)
    assert np.all(np.isfinite(blog2["controls"]))
    assert np.all(np.isfinite(blog2["economicKpi"]))


def test_quasi_newton_warm_start_and_tolerance(problem):
    """Warm-started FBE with tolerance terminates in fewer iterations
    than a cold start and lands at the same control."""
    from rapidnet_jax.solver import quasi_newton
    kw = dict({k: v for k, v in problem["kw"].items()
               if k != "max_iterations"},
              max_iterations=120, lbfgs_buffer_size=4,
              algorithm="globalFbeAlgorithm", tolerance=5e-2)
    run = jax.jit(quasi_newton.make_solver(**kw))
    step = problem["steps"][0]
    cold = run(problem["fa"], step, None)
    it_cold = int(cold["iterations"])
    warm = run(problem["fa"], step,
               {"xi": cold["y"]["xi"], "psi": cold["y"]["psi"]})
    it_warm = int(warm["iterations"])
    assert 0 < it_warm < it_cold, (it_warm, it_cold)
    np.testing.assert_allclose(np.asarray(warm["control"]),
                               np.asarray(cold["control"]),
                               rtol=5e-2, atol=5e-3)


def test_batched_controller_tolerance_early_exit(problem):
    """tolerance= on the batched controller exits early on the XLA path."""
    cfg, net, tree = problem["cfg"], problem["net"], problem["tree"]
    fc = synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=6, seed=3)
    bctrl = BatchedSmpcController(cfg, net, tree, fc, problem["x0s"],
                                  tolerance=1e-1)
    bctrl.control_action(0)
    iters = np.asarray(bctrl._last["iterations"])
    assert np.all(iters <= cfg.max_iterations)
    assert np.all(iters >= 1)
