"""APG solver golden tests against the reference's smpcTest.json.

Counterpart of TestSmpcController (src/test/TestSmpcController.cu):
each solver sub-step is tested in isolation by injecting its input state
from the fixture and comparing outputs, at the reference tolerance
(1e-1 absolute with a relative fallback for large values,
src/test/TestSmpcController.cu:31-43).
"""

import jax
import numpy as np
import pytest

from rapidnet_jax.engine.engine import XS_UPPER
from rapidnet_jax.io import jsonio
from rapidnet_jax.solver import solve_step as ss
from tests.conftest import fixture_path, requires_reference


def assert_close_ref(mine, ref, msg=""):
    """Reference compare: abs tol 1e-1; rel 1e-3 for |value| > 100."""
    mine = np.asarray(mine, np.float32).reshape(-1)
    ref = np.asarray(ref, np.float32).reshape(-1)
    assert mine.shape == ref.shape, f"{msg}: shape {mine.shape} vs {ref.shape}"
    diff = np.abs(mine - ref)
    big = np.abs(mine) > 1e2
    ok = np.where(big, diff / np.maximum(np.abs(mine), 1e-30) < 1e-3,
                  diff < 1e-1)
    if not ok.all():
        idx = np.flatnonzero(~ok)[:10]
        raise AssertionError(
            f"{msg}: {np.size(idx)}+ mismatches, first at {idx.tolist()}: "
            f"mine={mine[idx].tolist()} ref={ref[idx].tolist()}")


@pytest.fixture(scope="module")
def golden():
    return jsonio.load_json(fixture_path("smpcTest.json"))


@pytest.fixture(scope="module")
def setup(ref_problem, ref_engine):
    """fa/step arrays at timeInst=1 (solveStep auto-initialises with the
    config state + forecast 1, src/SmpcController.cu:579-582)."""
    from rapidnet_jax.solver.controller import _factor_arrays, _step_arrays
    fc = ref_problem["forecaster"]
    cfg = ref_problem["config"]
    fc.predict_demand(1)
    fc.predict_prices(1)
    fa = _factor_arrays(ref_engine)
    step = _step_arrays(ref_engine.prepare_step(
        fc.nominal_demand, fc.nominal_prices,
        cfg.current_x, cfg.prev_u, cfg.prev_demand))
    tree = ref_problem["tree"]

    def to_fan(flat, dim):
        node_vals = np.asarray(flat, np.float32).reshape(tree.n_nodes, dim)
        return tree.gather_to_fan(node_vals)

    def from_fan(fan):
        return tree.scatter_from_fan(np.asarray(fan)).reshape(-1)

    return dict(fa=fa, step=step, tree=tree, cfg=cfg,
                to_fan=to_fan, from_fan=from_fan,
                prefix_stages=ref_engine.factor_step().prefix_stages)


@requires_reference
def test_extrapolation(golden, setup):
    """w = (1+lam) y_k - lam y_{k-1} (src/SmpcController.cu:535-557)."""
    to_fan, from_fan = setup["to_fan"], setup["from_fan"]
    nx, nu = setup["cfg"].nx, setup["cfg"].nu
    xi = to_fan(golden["xi"], 2 * nx)
    psi = to_fan(golden["psi"], nu)
    upd_xi = to_fan(golden["updateXi"], 2 * nx)
    upd_psi = to_fan(golden["updatePsi"], nu)
    th = np.asarray(golden["theta"], np.float32)
    lam = th[1] * (1.0 / th[0] - 1.0)
    acc_xi = (1 + lam) * upd_xi - lam * xi
    acc_psi = (1 + lam) * upd_psi - lam * psi
    assert_close_ref(from_fan(acc_xi), golden["acceleXi"], "acceleXi")
    assert_close_ref(from_fan(acc_psi), golden["accelePsi"], "accelePsi")
    # y_k <- y_{k-1}
    assert_close_ref(from_fan(upd_xi), golden["finalXi"], "finalXi")
    assert_close_ref(from_fan(upd_psi), golden["finalPsi"], "finalPsi")


@requires_reference
def test_solve_step(golden, setup):
    """Dual-gradient oracle vs fixture X/U/primal
    (TestSmpcController::testSoveStep, .cu:173-216)."""
    to_fan, from_fan, fa, step = (setup["to_fan"], setup["from_fan"],
                                  setup["fa"], setup["step"])
    nx, nu = setup["cfg"].nx, setup["cfg"].nu
    w_xi = to_fan(golden["acceleXi"], 2 * nx)
    w_psi = to_fan(golden["accelePsi"], nu)
    sol = jax.jit(
        lambda fa_, wxi, wpsi, st: ss.solve_step(
            fa_, wxi, wpsi, st["beta"], st["uhat"], st["e"], st["x0"],
            st["prev_u"], st["prev_uhat"],
            prefix_stages=setup["prefix_stages"]),
        static_argnames=())(fa, w_xi, w_psi, step)
    assert_close_ref(from_fan(sol["x"]), golden["X"], "X")
    assert_close_ref(from_fan(sol["u"]), golden["U"], "U")
    # primal Hx/Hu checked against the prox-test fixture snapshot
    assert_close_ref(from_fan(sol["prim_xi"]), golden["primalX"], "primalX")
    assert_close_ref(from_fan(sol["prim_psi"]), golden["primalU"], "primalU")


@requires_reference
def test_proximal_step(golden, setup):
    """prox_g on the fixture primal/accelerated pair
    (TestSmpcController::testProximalStep, .cu:221-286)."""
    to_fan, from_fan, fa, cfg = (setup["to_fan"], setup["from_fan"],
                                 setup["fa"], setup["cfg"])
    nx, nu = cfg.nx, cfg.nu
    prim_xi = to_fan(golden["primalX"], 2 * nx)
    prim_psi = to_fan(golden["primalU"], nu)
    w_xi = to_fan(golden["acceleXi"], 2 * nx)
    w_psi = to_fan(golden["accelePsi"], nu)
    dual_xi, dual_psi, _ = jax.jit(
        lambda *a: ss.prox_g(
            *a, inv_step=1.0 / cfg.step_size,
            penalty_state=cfg.penalty_state,
            penalty_safety=cfg.penalty_safety,
            xs_upper=float(XS_UPPER)))(fa, prim_xi, prim_psi, w_xi, w_psi)
    assert_close_ref(from_fan(dual_xi), golden["dualX"], "dualX")
    assert_close_ref(from_fan(dual_psi), golden["dualU"], "dualU")


@pytest.fixture(scope="module")
def oracle_out(golden, setup):
    """One REAL solver iteration (apg.apg_oracle — the exact code the
    APG loop runs) at the fixture's injected accelerated dual.

    Unlike recomputing the residual/update identities from fixture
    arrays, this drives solve_step -> prox_g -> residual -> dual
    update through rapidnet_jax.solver.apg, so a regression anywhere
    in that chain (e.g. a flipped residual sign) fails these tests.
    """
    from rapidnet_jax.solver import apg as apg_mod
    to_fan, cfg = setup["to_fan"], setup["cfg"]
    nx, nu = cfg.nx, cfg.nu
    w_xi = to_fan(golden["acceleXi"], 2 * nx)
    w_psi = to_fan(golden["accelePsi"], nu)
    fn = jax.jit(lambda fa, st, wxi, wpsi: apg_mod.apg_oracle(
        fa, st, wxi, wpsi, prefix_stages=setup["prefix_stages"],
        inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
        penalty_state=cfg.penalty_state,
        penalty_safety=cfg.penalty_safety, xs_upper=float(XS_UPPER)))
    return fn(setup["fa"], setup["step"], w_xi, w_psi)


@requires_reference
def test_fixed_point_residual(golden, setup, oracle_out):
    """Hz - t through the solver chain (src/SmpcController.cu:839-850;
    TestSmpcController::testFixedPointResidual, .cu:345-398)."""
    from_fan = setup["from_fan"]
    assert_close_ref(from_fan(oracle_out["res_xi"]),
                     golden["fixedPointResidualXi"], "residualXi")
    assert_close_ref(from_fan(oracle_out["res_psi"]),
                     golden["fixedPointResidualPsi"], "residualPsi")


@requires_reference
def test_dual_update(golden, setup, oracle_out):
    """y+ = w + step * residual through the solver chain
    (src/SmpcController.cu:859-864; testDualUpdate, .cu:291-340)."""
    from_fan = setup["from_fan"]
    assert_close_ref(from_fan(oracle_out["y_xi"]),
                     golden["finalUpdateXi"], "finalUpdateXi")
    assert_close_ref(from_fan(oracle_out["y_psi"]),
                     golden["finalUpdatePsi"], "finalUpdatePsi")


@requires_reference
def test_apg_end_to_end(setup):
    """Full 500-iteration APG: infeasibility decreases, control feasible."""
    from rapidnet_jax.solver import apg as apg_mod
    cfg, fa, step = setup["cfg"], setup["fa"], setup["step"]
    run = jax.jit(apg_mod.make_apg(
        prefix_stages=setup["prefix_stages"],
        inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
        penalty_state=cfg.penalty_state, penalty_safety=cfg.penalty_safety,
        xs_upper=float(XS_UPPER), max_iterations=cfg.max_iterations))
    out = run(fa, step)
    infs = np.abs(np.asarray(out["primal_infeasibility"]))
    assert np.isfinite(infs).all()
    # convergence: last-50 mean infeasibility well below first-50 mean
    assert infs[-50:].mean() < 0.5 * infs[:50].mean()
    u0 = np.asarray(out["control"])
    fa_np = {k: np.asarray(v) for k, v in fa.items()
             if not isinstance(v, dict)}
    assert (u0 >= fa_np["umin"][0, 0] - 1e-5).all()
    assert (u0 <= fa_np["umax"][0, 0] + 1e-5).all()
