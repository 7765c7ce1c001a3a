"""FBE / NAMA golden tests against smpcFbeTest.json / smpcNamaTest.json.

Counterpart of Testing::testSmpcFbeController / testSmpcNamaController
(src/test/Testing.cu:536-595) driving the TestSmpcController sub-step
tests (src/test/TestSmpcController.cu:403-1064).
"""

import jax
import numpy as np
import pytest

from rapidnet_jax.engine.engine import XS_UPPER, Engine
from rapidnet_jax.io import jsonio
from rapidnet_jax.model.config import SmpcConfig
from rapidnet_jax.solver import quasi_newton as qn
from rapidnet_jax.solver import solve_step as ss
from tests.conftest import fixture_path, requires_reference
from tests.test_solver_golden import assert_close_ref


def _setup(ref_problem, config_name):
    from rapidnet_jax.solver.controller import _factor_arrays, _step_arrays
    cfg = SmpcConfig.from_json(fixture_path(config_name))
    net = ref_problem["network"]
    tree = ref_problem["tree"]
    fc = ref_problem["forecaster"]
    eng = Engine(net, tree, cfg)
    fc.predict_demand(1)
    fc.predict_prices(1)
    fa = _factor_arrays(eng)
    step = _step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices,
        cfg.current_x, cfg.prev_u, cfg.prev_demand))

    def to_fan(flat, dim):
        node_vals = np.asarray(flat, np.float32).reshape(tree.n_nodes, dim)
        return tree.gather_to_fan(node_vals)

    def from_fan(fan):
        return tree.scatter_from_fan(np.asarray(fan)).reshape(-1)

    return dict(fa=fa, step=step, tree=tree, cfg=cfg, eng=eng,
                to_fan=to_fan, from_fan=from_fan,
                prefix_stages=eng.factor_step().prefix_stages,
                prox_kwargs=dict(inv_step=1.0 / cfg.step_size,
                                 penalty_state=cfg.penalty_state,
                                 penalty_safety=cfg.penalty_safety,
                                 xs_upper=float(XS_UPPER)))


@pytest.fixture(scope="module", params=["fbe", "nama"])
def variant(request, ref_problem):
    name = request.param
    golden = jsonio.load_json(fixture_path(
        "smpcFbeTest.json" if name == "fbe" else "smpcNamaTest.json"))
    cfgname = ("controllerFbeConfig.json" if name == "fbe"
               else "controllerNamaConfig.json")
    st = _setup(ref_problem, cfgname)
    st["golden"] = golden
    st["name"] = name
    return st


def _dual_from_golden(v, keys, nx, nu):
    return {"xi": v["to_fan"](v["golden"][keys[0]], 2 * nx),
            "psi": v["to_fan"](v["golden"][keys[1]], nu)}


@requires_reference
def test_solve_prox_residual(variant):
    """testSoveStep/testProximalStep/testFixedPointResidual for the
    FBE/NAMA fixture states."""
    v = variant
    g = v["golden"]
    nx, nu = v["cfg"].nx, v["cfg"].nu
    w = _dual_from_golden(v, ("acceleXi", "accelePsi"), nx, nu)
    sol = ss.solve_step(
        v["fa"], w["xi"], w["psi"], v["step"]["beta"], v["step"]["uhat"],
        v["step"]["e"], v["step"]["x0"], v["step"]["prev_u"],
        v["step"]["prev_uhat"], prefix_stages=v["prefix_stages"])
    assert_close_ref(v["from_fan"](sol["x"]), g["X"], "X")
    assert_close_ref(v["from_fan"](sol["u"]), g["U"], "U")
    assert_close_ref(v["from_fan"](sol["prim_xi"]), g["primalX"], "primalX")
    assert_close_ref(v["from_fan"](sol["prim_psi"]), g["primalU"],
                     "primalU")
    dual_xi, dual_psi, _ = ss.prox_g(
        v["fa"], sol["prim_xi"], sol["prim_psi"], w["xi"], w["psi"],
        **v["prox_kwargs"])
    assert_close_ref(v["from_fan"](dual_xi), g["dualX"], "dualX")
    assert_close_ref(v["from_fan"](dual_psi), g["dualU"], "dualU")


@requires_reference
def test_hessian_oracle(variant):
    """testHessianOracalGlobalFbe (.cu:403-453): oracle on the residual."""
    v = variant
    g = v["golden"]
    nx, nu = v["cfg"].nx, v["cfg"].nu
    res = _dual_from_golden(
        v, ("fixedPointResidualXi", "fixedPointResidualPsi"), nx, nu)
    h = qn.oracle(v["fa"], res["xi"], res["psi"],
                  prefix_stages=v["prefix_stages"])
    key = ("fbeHessianDirXdir" if v["name"] == "fbe"
           else "ameFixedPointDirXdir")
    key_u = ("fbeHessianDirUdir" if v["name"] == "fbe"
             else "ameFixedPointDirUdir")
    assert_close_ref(v["from_fan"](h["x"]), g[key], "Xdir")
    assert_close_ref(v["from_fan"](h["u"]), g[key_u], "Udir")


@requires_reference
def test_fbe_gradient(variant):
    """testFbeGradient (.cu:459-502): grad = -res + step*H(linmap(-res))."""
    v = variant
    if v["name"] != "fbe":
        pytest.skip("FBE only")
    g = v["golden"]
    nx, nu = v["cfg"].nx, v["cfg"].nu
    res = _dual_from_golden(
        v, ("fixedPointResidualXi", "fixedPointResidualPsi"), nx, nu)
    h = qn.oracle(v["fa"], -res["xi"], -res["psi"],
                  prefix_stages=v["prefix_stages"])
    grad_xi = -res["xi"] + v["cfg"].step_size * h["prim_xi"]
    grad_psi = -res["psi"] + v["cfg"].step_size * h["prim_psi"]
    assert_close_ref(v["from_fan"](grad_xi), g["fbeGradXi"], "fbeGradXi")
    assert_close_ref(v["from_fan"](grad_psi), g["fbeGradPsi"],
                     "fbeGradPsi")


def _value_g_from_fixture(v):
    """g-cost pieces as left by the prox state the reference carries."""
    g = v["golden"]
    nx, nu = v["cfg"].nx, v["cfg"].nu
    prim = _dual_from_golden(v, ("primalX", "primalU"), nx, nu)
    w = _dual_from_golden(v, ("acceleXi", "accelePsi"), nx, nu)
    _, _, value_g = ss.prox_g(v["fa"], prim["xi"], prim["psi"],
                              w["xi"], w["psi"], **v["prox_kwargs"])
    return value_g


@requires_reference
def test_value_fbe(variant):
    """testValueFbe (.cu:679-746), rel tolerance 1e-3."""
    v = variant
    g = v["golden"]
    nx, nu = v["cfg"].nx, v["cfg"].nu
    res = _dual_from_golden(
        v, ("fixedPointResidualXi", "fixedPointResidualPsi"), nx, nu)
    w = _dual_from_golden(v, ("acceleXi", "accelePsi"), nx, nu)
    u = v["to_fan"](g["U"], nu)
    value_g = _value_g_from_fixture(v)
    val = qn.value_fbe(v["fa"], v["step"], w, u, res, value_g,
                       step_size=v["cfg"].step_size)
    ref = float(np.asarray(g["fbeObjDual"]).reshape(-1)[0])
    assert abs(float(val) - ref) / abs(ref) < 1e-3, (float(val), ref)


@requires_reference
def test_lbfgs_direction(variant):
    """testLbfgsDirection (.cu:507-625)."""
    v = variant
    g = v["golden"]
    cfg = v["cfg"]
    nx, nu = cfg.nx, cfg.nu
    tree = v["tree"]
    nodes = tree.n_nodes
    bs = cfg.lbfgs_buffer_size
    ny_xi = 2 * nx * nodes
    ny = (2 * nx + nu) * nodes

    y = _dual_from_golden(v, ("acceleXi", "accelePsi"), nx, nu)
    y_prev = _dual_from_golden(v, ("xi", "psi"), nx, nu)
    yvec = _dual_from_golden(
        v, ("lbfgsCurrentYvecXi", "lbfgsCurrentYvecPsi"), nx, nu)
    yvec_prev = _dual_from_golden(
        v, ("lbfgsPreviousYvecXi", "lbfgsPreviousYvecPsi"), nx, nu)

    # fixture buffers: bs columns, each [xi-part | psi-part] node layout
    mat_s_flat = np.asarray(g["matS"], np.float32).reshape(bs, ny)
    mat_y_flat = np.asarray(g["matY"], np.float32).reshape(bs, ny)
    n_cols = bs + 1

    def to_buf(flat):
        xi = np.zeros((n_cols,) + y["xi"].shape, np.float32)
        psi = np.zeros((n_cols,) + y["psi"].shape, np.float32)
        for c in range(bs):
            xi[c] = v["to_fan"](flat[c, :ny_xi], 2 * nx)
            psi[c] = v["to_fan"](flat[c, ny_xi:], nu)
        return {"xi": xi, "psi": psi}

    inv_rho_fix = np.asarray(g["vecInvRho"], np.float32).reshape(-1)[:bs]
    rho = np.zeros(n_cols, np.float32)
    rho[:bs] = np.where(inv_rho_fix != 0, 1.0 / np.where(
        inv_rho_fix == 0, 1.0, inv_rho_fix), 0.0)
    lb = {
        "mat_s": to_buf(mat_s_flat), "mat_y": to_buf(mat_y_flat),
        "rho": rho,
        "col": np.int32(np.asarray(g["colLbfgs"]).reshape(-1)[0]),
        "mem": np.int32(np.asarray(g["memLbfgs"]).reshape(-1)[0]),
        "skips": np.int32(0),
        "hessian": np.float32(np.asarray(g["H"]).reshape(-1)[0]),
    }
    lb_new, d = qn.lbfgs_update_and_direction(
        v["fa"], lb, y, y_prev, yvec, yvec_prev, buffer_size=bs)

    assert int(lb_new["col"]) == int(
        np.asarray(g["updateColLbfgs"]).reshape(-1)[0])
    assert int(lb_new["mem"]) == int(
        np.asarray(g["updateMemLbfgs"]).reshape(-1)[0])
    upd_h = float(np.asarray(g["updateH"]).reshape(-1)[0])
    assert abs(float(lb_new["hessian"]) - upd_h) < 1e-1

    upd_inv_rho = np.asarray(g["updateVecInvRho"], np.float32).reshape(-1)
    mine_rho = np.asarray(lb_new["rho"])[:bs]
    for i in range(min(bs, upd_inv_rho.size)):
        ref = (1.0 / upd_inv_rho[i]) if upd_inv_rho[i] != 0 else 0.0
        assert abs(mine_rho[i] - ref) < 1e-1, (i, mine_rho[i], ref)

    upd_s = np.asarray(g["updateMatS"], np.float32).reshape(bs, ny)
    upd_y = np.asarray(g["updateMatY"], np.float32).reshape(bs, ny)
    for c in range(bs):
        assert_close_ref(
            np.concatenate([v["from_fan"](lb_new["mat_s"]["xi"][c]),
                            v["from_fan"](lb_new["mat_s"]["psi"][c])]),
            upd_s[c], f"matS col {c}")
        assert_close_ref(
            np.concatenate([v["from_fan"](lb_new["mat_y"]["xi"][c]),
                            v["from_fan"](lb_new["mat_y"]["psi"][c])]),
            upd_y[c], f"matY col {c}")

    assert_close_ref(v["from_fan"](d["xi"]), g["lbfgsDirXi"], "lbfgsDirXi")
    assert_close_ref(v["from_fan"](d["psi"]), g["lbfgsDirPsi"],
                     "lbfgsDirPsi")


@requires_reference
def test_line_search(variant):
    """testFbeLineSearch (.cu:851-958) / testAmeLineSearch (.cu:748-847)."""
    v = variant
    g = v["golden"]
    cfg = v["cfg"]
    nx, nu = cfg.nx, cfg.nu
    res = _dual_from_golden(
        v, ("fixedPointResidualXi", "fixedPointResidualPsi"), nx, nu)
    w = _dual_from_golden(v, ("acceleXi", "accelePsi"), nx, nu)
    prim = _dual_from_golden(v, ("primalX", "primalU"), nx, nu)
    lbfgs_dir = _dual_from_golden(v, ("lbfgsDirXi", "lbfgsDirPsi"), nx, nu)
    x = v["to_fan"](g["X"], nx)
    u = v["to_fan"](g["U"], nu)
    value_g = _value_g_from_fixture(v)
    state = {"x": x, "u": u, "w": w, "prim": prim,
             "dual": {"xi": prim["xi"] - res["xi"],
                      "psi": prim["psi"] - res["psi"]},
             "res": res, "value_g": value_g}
    value = qn.value_fbe(v["fa"], v["step"], w, u, res, value_g,
                         step_size=cfg.step_size)
    ref_val = float(np.asarray(g["fbeObjDual"]).reshape(-1)[0])
    assert abs(float(value) - ref_val) / abs(ref_val) < 1e-3

    if v["name"] == "fbe":
        grad = _dual_from_golden(v, ("fbeGradXi", "fbeGradPsi"), nx, nu)
        st, tau = jax.jit(lambda *a: qn.fbe_line_search(
            *a, prefix_stages=v["prefix_stages"],
            prox_kwargs=v["prox_kwargs"], step_size=cfg.step_size))(
                v["fa"], v["step"], state, grad, lbfgs_dir, value)
    else:
        st, tau = jax.jit(lambda *a: qn.ame_line_search(
            *a, prefix_stages=v["prefix_stages"],
            prox_kwargs=v["prox_kwargs"], step_size=cfg.step_size))(
                v["fa"], v["step"], state, lbfgs_dir, value)

    ref_tau = float(np.asarray(g["tau"]).reshape(-1)[0])
    assert abs(float(tau) - ref_tau) < 1e-1, (float(tau), ref_tau)
    assert_close_ref(v["from_fan"](st["w"]["xi"]), g["updateXi"],
                     "updateXi")
    assert_close_ref(v["from_fan"](st["w"]["psi"]), g["updatePsi"],
                     "updatePsi")
    assert_close_ref(v["from_fan"](st["res"]["xi"]),
                     g["updateResidualXi"], "updateResidualXi")
    assert_close_ref(v["from_fan"](st["res"]["psi"]),
                     g["updateResidualPsi"], "updateResidualPsi")


@requires_reference
def test_dual_update(variant):
    """testFbeDualUpdate (.cu:958-1064): y = w + step*res."""
    v = variant
    g = v["golden"]
    nx, nu = v["cfg"].nx, v["cfg"].nu
    w = _dual_from_golden(v, ("updateXi", "updatePsi"), nx, nu)
    res = _dual_from_golden(
        v, ("updateResidualXi", "updateResidualPsi"), nx, nu)
    y_xi = w["xi"] + v["cfg"].step_size * res["xi"]
    y_psi = w["psi"] + v["cfg"].step_size * res["psi"]
    assert_close_ref(v["from_fan"](y_xi), g["finalUpdateXi"],
                     "finalUpdateXi")
    assert_close_ref(v["from_fan"](y_psi), g["finalUpdatePsi"],
                     "finalUpdatePsi")


@requires_reference
def test_nama_yvec(variant):
    """testUpdateFixedPointResidualNamaAlgorithm (.cu:631-674)."""
    v = variant
    if v["name"] != "nama":
        pytest.skip("NAMA only")
    g = v["golden"]
    nx, nu = v["cfg"].nx, v["cfg"].nu
    res = _dual_from_golden(
        v, ("fixedPointResidualXi", "fixedPointResidualPsi"), nx, nu)
    assert_close_ref(v["from_fan"](-res["xi"]), g["lbfgsCurrentYvecXi"],
                     "yvecXi")
    assert_close_ref(v["from_fan"](-res["psi"]), g["lbfgsCurrentYvecPsi"],
                     "yvecPsi")


@requires_reference
def test_full_fbe_nama_run(variant):
    """End-to-end FBE/NAMA: the loop stays finite and produces a
    feasible control.

    Note: the reference never exercises its FBE/NAMA loops end-to-end
    (controlAction always dispatches algorithmApg,
    src/SmpcController.cu:1617/1646), so there is no golden trajectory;
    the per-substep fixtures above are the parity contract.  The
    quasi-Newton dual iterates take much larger steps than APG and the
    infeasibility trace oscillates by design of the reference's
    keep-last-trial line search."""
    v = variant
    cfg = v["cfg"]
    run = jax.jit(qn.make_solver(
        algorithm=cfg.algorithm, prefix_stages=v["prefix_stages"],
        inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
        penalty_state=cfg.penalty_state, penalty_safety=cfg.penalty_safety,
        xs_upper=float(XS_UPPER), max_iterations=40,
        lbfgs_buffer_size=cfg.lbfgs_buffer_size))
    out = run(v["fa"], v["step"])
    infs = np.abs(np.asarray(out["primal_infeasibility"]))
    assert np.isfinite(infs).all()
    assert np.isfinite(np.asarray(out["value_fbe"])).all()
    # no blow-up: stays within two orders of the first iterate
    assert np.median(infs[-10:]) < 100.0 * (infs[1] + 1.0)
    assert np.isfinite(np.asarray(out["control"])).all()
