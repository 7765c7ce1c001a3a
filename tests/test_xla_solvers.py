"""Properties of the XLA solve path, for all three algorithms: early
exit and warm start, L-BFGS buffer handling, batched == per-instance
with shared and unshared forecasts, and the multichip dry run."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rapidnet_jax.model.config import synthetic_config
from rapidnet_jax.model.forecaster import synthetic_forecaster
from rapidnet_jax.model.network import synthetic_network
from rapidnet_jax.model.scenario_tree import generate_tree
from rapidnet_jax.solver import quasi_newton
from rapidnet_jax.solver.batch import BatchedSmpcController
from rapidnet_jax.solver.controller import SmpcController, _step_arrays

ALGORITHMS = ["proximalAlgorithm", "globalFbeAlgorithm", "namaAlgorithm"]
B = 3


@pytest.fixture(scope="module")
def problem():
    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=3)
    tree = generate_tree(N=8, branching=[2, 2], nd=3, nu=7, seed=3)
    cfg = synthetic_config(net, tree, max_iterations=30, step_size=1e-3)
    rng = np.random.default_rng(17)
    x0s = (cfg.current_x * (0.9 + 0.2 * rng.random((B, cfg.nx)))
           ).astype(np.float32)
    return dict(net=net, tree=tree, cfg=cfg, x0s=x0s)


def _fc():
    return synthetic_forecaster(N=8, nd=3, nu=7, sim_horizon=6, seed=3)


def _controller(problem, algorithm, **kw):
    cfg = dataclasses.replace(copy.deepcopy(problem["cfg"]),
                              algorithm=algorithm,
                              max_iterations=kw.pop("max_iterations", 30))
    return SmpcController(cfg, network=problem["net"], tree=problem["tree"],
                          forecaster=_fc(), **kw)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_tolerance_early_exit_and_warm_start(problem, algorithm):
    """With a tolerance the solve stops before its budget, and a solve
    warm-started from the converged duals stops sooner and lands at the
    same control."""
    ctrl = _controller(problem, algorithm, max_iterations=400,
                       tolerance=5e-2)
    ctrl.initialise()
    step = ctrl.prepare_step(0)
    cold = ctrl._solver(ctrl._fa, step, None)
    it_cold = int(cold["iterations"])
    assert 0 < it_cold < 400
    assert np.all(np.asarray(cold["primal_infeasibility"])[it_cold:] == 0)
    warm = ctrl._solver(ctrl._fa, step, cold["y"])
    it_warm = int(warm["iterations"])
    assert 0 < it_warm < it_cold, (it_warm, it_cold)
    np.testing.assert_allclose(np.asarray(warm["control"]),
                               np.asarray(cold["control"]),
                               rtol=5e-2, atol=5e-3)


@pytest.mark.parametrize("buffer_size", [1, 2, 5])
def test_lbfgs_buffer_rolls_through_its_columns(buffer_size):
    """The 1-based rolling column of updateLbfgsBuffer
    (src/SmpcController.cu:1103-1177): accepted pairs land in columns
    1..size in turn, column 0 stays empty, memory saturates at size."""
    rng = np.random.default_rng(buffer_size)
    shape = (2, 3, 4)
    rep = jnp.ones(shape[:2], jnp.float32)
    n_cols = buffer_size + 1

    def dual(scale=1.0):
        return {k: jnp.asarray(scale * rng.standard_normal(shape),
                               jnp.float32) for k in ("xi", "psi")}

    zeros = {k: jnp.zeros((n_cols,) + shape, jnp.float32)
             for k in ("xi", "psi")}
    lb = {"mat_s": dict(zeros), "mat_y": dict(zeros),
          "rho": jnp.zeros((n_cols,), jnp.float32), "col": jnp.int32(0),
          "mem": jnp.int32(0), "skips": jnp.int32(0),
          "hessian": jnp.float32(1.0)}
    y_prev, g_prev = dual(), dual()
    cols = []
    for i in range(2 * buffer_size + 1):
        s = dual(0.1)
        y = {k: y_prev[k] + s[k] for k in s}
        # a curvature pair with <s, yv> > 0 is always accepted
        g = {k: g_prev[k] + 2.0 * s[k] for k in s}
        lb, d = quasi_newton.lbfgs_update_and_direction(
            {"rep": rep}, lb, y, y_prev, g, g_prev, buffer_size=buffer_size)
        cols.append(int(lb["col"]))
        assert int(lb["mem"]) == min(i + 1, buffer_size)
        assert all(np.isfinite(np.asarray(v)).all() for v in d.values())
        y_prev, g_prev = y, g
    assert cols == [1 + (i % buffer_size) for i in range(len(cols))]
    assert int(lb["skips"]) == 0
    assert lb["mat_s"]["xi"].shape == (n_cols,) + shape
    np.testing.assert_array_equal(np.asarray(lb["mat_s"]["xi"][0]), 0.0)
    assert float(lb["rho"][0]) == 0.0


@pytest.mark.parametrize("algorithm", ["globalFbeAlgorithm",
                                       "namaAlgorithm"])
@pytest.mark.parametrize("buffer_size", [1, 5])
def test_quasi_newton_buffer_sizes_solve(problem, algorithm, buffer_size):
    cfg = dataclasses.replace(copy.deepcopy(problem["cfg"]),
                              algorithm=algorithm,
                              lbfgs_buffer_size=buffer_size)
    ctrl = SmpcController(cfg, network=problem["net"], tree=problem["tree"],
                          forecaster=_fc())
    u = ctrl.control_action(0)
    assert np.isfinite(u).all()
    assert np.isfinite(np.asarray(ctrl._last["value_fbe"])).all()


# Batched vs per-instance tolerances (tests/test_batch.py): the APG
# lanes do the single solve's arithmetic; vmapped FBE/NAMA line searches
# run in masked lockstep; the shared-forecast path assembles beta on
# device, and that rounding-level difference can flip a line-search
# branch (the tier of the identical-lanes closed-loop test).
def _batch_tol(algorithm, shared):
    if algorithm == "proximalAlgorithm":
        return dict(rtol=1e-4, atol=1e-5)
    if shared:
        return dict(rtol=6e-2, atol=5e-3)
    return dict(rtol=1e-2, atol=2e-3)


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared_forecast", "per_instance_forecast"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_batched_step_matches_single_solves(problem, algorithm, shared):
    cfg = dataclasses.replace(copy.deepcopy(problem["cfg"]),
                              algorithm=algorithm, max_iterations=15)
    fcs = _fc() if shared else [_fc() for _ in range(B)]
    bctrl = BatchedSmpcController(cfg, problem["net"], problem["tree"],
                                  fcs, problem["x0s"])
    assert bctrl._shared_forecast == shared
    u_batch = bctrl.control_action(0)

    single = SmpcController(copy.deepcopy(cfg), network=problem["net"],
                            tree=problem["tree"], forecaster=_fc())
    single.initialise()
    fc = _fc()
    fc.predict_demand(0)
    fc.predict_prices(0)
    for b in range(B):
        step = _step_arrays(single.engine.prepare_step(
            fc.nominal_demand, fc.nominal_prices, problem["x0s"][b],
            cfg.prev_u, cfg.prev_demand))
        u_1 = np.asarray(single._solver(single._fa, step, None)["control"])
        np.testing.assert_allclose(u_batch[b], u_1,
                                   **_batch_tol(algorithm, shared))


def test_dryrun_multichip_on_virtual_cpu_devices():
    """The dry run uses the devices it is given; a short device list is
    an error, not a silent swap."""
    import __graft_entry__ as g
    g.dryrun_multichip(4, devices=jax.devices("cpu"))
    with pytest.raises(RuntimeError, match="only 2 devices"):
        g.dryrun_multichip(4, devices=jax.devices("cpu")[:2])
