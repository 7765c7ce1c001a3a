"""Tests that need an NVIDIA GPU (marker ``gpu``; they skip elsewhere).

Run on a GPU machine with ``RAPIDNET_GPU_TESTS=1 python -m pytest tests/
-q -m gpu``.  Each compiles the XLA solve for the card and compares it
with the same program on the host CPU, in one process.
"""

import jax
import numpy as np
import pytest

from rapidnet_jax.engine.engine import XS_UPPER, Engine
from rapidnet_jax.model.config import synthetic_config
from rapidnet_jax.model.forecaster import synthetic_forecaster
from rapidnet_jax.model.network import synthetic_network
from rapidnet_jax.model.scenario_tree import generate_tree
from rapidnet_jax.solver import apg, quasi_newton
from rapidnet_jax.solver.controller import _factor_arrays, _step_arrays

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def small_problem():
    net = synthetic_network(nx=6, nu=10, nd=5, ne=3, seed=3)
    tree = generate_tree(N=8, branching=[3, 2], nd=5, nu=10, seed=3)
    fc = synthetic_forecaster(N=8, nd=5, nu=10, sim_horizon=4, seed=3)
    cfg = synthetic_config(net, tree, max_iterations=10, step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    step = _step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, cfg.current_x, cfg.prev_u,
        cfg.prev_demand))
    kw = dict(prefix_stages=eng.factor_step().prefix_stages,
              inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
              penalty_state=cfg.penalty_state,
              penalty_safety=cfg.penalty_safety, xs_upper=float(XS_UPPER),
              max_iterations=10)
    return _factor_arrays(eng), step, kw


def _on(device, fn, fa, step):
    out = jax.jit(fn)(jax.device_put(fa, device), jax.device_put(step, device))
    return np.asarray(out["control"])


@pytest.mark.parametrize("algorithm", ["proximalAlgorithm",
                                       "globalFbeAlgorithm",
                                       "namaAlgorithm"])
def test_gpu_solve_matches_cpu(gpu_device, small_problem, algorithm):
    """Short budget: every part of an iteration has run, and the card's
    other summation order stays far below 1e-4 relative."""
    fa, step, kw = small_problem
    if algorithm == "proximalAlgorithm":
        fn = apg.make_apg(**kw)
    else:
        fn = quasi_newton.make_solver(algorithm=algorithm,
                                      lbfgs_buffer_size=4, **kw)
    u_gpu = _on(gpu_device, fn, fa, step)
    u_cpu = _on(jax.devices("cpu")[0], fn, fa, step)
    assert np.isfinite(u_gpu).all()
    scale = max(np.abs(u_cpu).max(), 1.0)
    assert np.abs(u_gpu - u_cpu).max() / scale <= 1e-4


def test_gpu_batched_matches_single(gpu_device, small_problem):
    fa, step, kw = small_problem
    steps = {k: np.stack([np.asarray(v)] * 4) for k, v in step.items()}
    steps["x0"] = steps["x0"] * np.linspace(0.9, 1.1, 4,
                                            dtype=np.float32)[:, None]
    fa_d = jax.device_put(fa, gpu_device)
    batched = np.asarray(jax.jit(apg.make_apg_batch(**kw))(
        fa_d, jax.device_put(steps, gpu_device))["control"])
    single = jax.jit(apg.make_apg(**kw))
    for b in range(4):
        one = {k: v[b] for k, v in steps.items()}
        u = np.asarray(single(fa_d, jax.device_put(one, gpu_device))
                       ["control"])
        np.testing.assert_allclose(batched[b], u, rtol=1e-5, atol=1e-6)
