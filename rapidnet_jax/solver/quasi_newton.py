"""Global-FBE and NAMA quasi-Newton dual solvers (L-BFGS accelerated).

Reference: ``algorithmGlobalFbe`` / ``algorithmNama``
(src/SmpcController.cu:1529-1586) with

* the FBE gradient  grad = -(Hz - t) + step * H(linmap(-(Hz - t)))
  where linmap is the Hessian oracle — the same backward/forward tree
  recursion as the solve step with the affine terms removed
  (computeHessianOracalGlobalFbe, src/SmpcController.cu:884-1055);
* an L-BFGS buffer over the dual pair (xi, psi) with the reference's
  1-based rolling column scheme (updateLbfgsBuffer, :1103-1177) and
  two-loop recursion (:1182-1232);
* backtracking line searches that *cumulatively* apply shrinking tau
  increments until the FBE value stops improving
  (computeLineSearchLbfgsUpdate :1250-1320, AME variant :1326-1414).

The reference syncs to the host for every norm/dot and runs the line
search in host control flow; here the complete iteration — including
both Hessian-oracle sweeps and the ``lax.while_loop`` line search — is
one jitted XLA program.

Faithfulness notes:
  * the reference's rolling column update ``col = 1 + (col % size)``
    can write one past its buffer when the wrap lands on col == size;
    we allocate size+1 columns so the same 1-based indexing is well
    defined.  Column 0 stays zero with rho[0] = 0, so the two-loop
    recursion's occasional visit to column 0 after wrap-around is a
    no-op, matching the reference's zero-initialised memory.
  * the line searches keep the last (worsening) trial applied, exactly
    as the reference's loops do — the golden fixtures encode this.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from rapidnet_jax.model.config import ALGORITHM_FBE, ALGORITHM_NAMA
from rapidnet_jax.solver import solve_step as ss

LS_TOLERANCE = 1e-4
LS_MAX_STEPS = 10


def masked_dot(a, b, rep, axis_name=None):
    """Dual-space dot counting each tree node once ((N,ns,d) fan layout)."""
    s = jnp.sum(rep[..., None] * a * b)
    if axis_name is not None:
        s = lax.psum(s, axis_name)
    return s


def dual_dot(a, b, rep, axis_name=None):
    return (masked_dot(a["xi"], b["xi"], rep, axis_name) +
            masked_dot(a["psi"], b["psi"], rep, axis_name))


def oracle(fa, xi, psi, *, prefix_stages, axis_name=None):
    """Hessian oracle: the solve-step linear map on a dual direction
    (computeHessianOracalGlobalFbe, src/SmpcController.cu:884-1055)."""
    N, ns = xi.shape[:2]
    nx = fa["d1"].shape[-1]
    nu = fa["g"].shape[-1]
    nv = fa["invWbar"].shape[0]
    f32 = xi.dtype
    return ss.solve_step(
        fa, xi, psi,
        jnp.zeros((N, ns, nv), f32), jnp.zeros((N, ns, nu), f32),
        jnp.zeros((N, ns, nx), f32), jnp.zeros((nx,), f32),
        jnp.zeros((nu,), f32), jnp.zeros((nu,), f32),
        prefix_stages=prefix_stages, axis_name=axis_name)


def value_fbe(fa, step, w, u, res, value_g, *, step_size, axis_name=None):
    """FBE value (computeValueFbe, src/SmpcController.cu:1417-1476):

    <w, r> + (step/2) ||r||^2 + g-values + f(u), with
    f = sum_n p_n du_n' W du_n + sum_n p_n u_n' alpha_n and
    du_n = u_n - u_anc(n) (root: - previous control).
    """
    rep = fa["rep"]
    val = dual_dot(w, res, rep, axis_name)
    val = val + 0.5 * step_size * dual_dot(res, res, rep, axis_name)
    val = val + value_g
    du0 = u[0] - step["prev_u"][None, :]
    du = jnp.concatenate([du0[None], u[1:] - u[:-1]], axis=0)
    Wdu = jnp.matmul(du, fa["W"].T, precision=ss.MM_PRECISION)
    p = fa["prob"]
    smooth = jnp.sum(rep[..., None] * (p * du) * Wdu)
    econ = jnp.sum(rep[..., None] * (p * u) * step["alpha_price"])
    if axis_name is not None:
        smooth = lax.psum(smooth, axis_name)
        econ = lax.psum(econ, axis_name)
    return val + smooth + econ


def lbfgs_update_and_direction(fa, lb, y, y_prev, yvec, yvec_prev, *,
                               buffer_size, axis_name=None):
    """L-BFGS buffer update + two-loop recursion.

    Reference: updateLbfgsBuffer (src/SmpcController.cu:1103-1177) and
    twoLoopRecursionLbfgs (:1182-1232).  lb holds mat_s/mat_y with
    buffer_size+1 columns (column 0 unused, see module docstring).
    """
    rep = fa["rep"]
    lb = jax.tree.map(jnp.asarray, lb)
    s = {"xi": y["xi"] - y_prev["xi"], "psi": y["psi"] - y_prev["psi"]}
    yv = {"xi": yvec["xi"] - yvec_prev["xi"],
          "psi": yvec["psi"] - yvec_prev["psi"]}
    norm_grad = jnp.sqrt(dual_dot(yvec, yvec, rep, axis_name))
    inv_rho = dual_dot(s, yv, rep, axis_name)
    norm_y2 = dual_dot(yv, yv, rep, axis_name)
    norm_s2 = dual_dot(s, s, rep, axis_name)

    norm_grad = jnp.where(norm_grad < 1.0, norm_grad ** 3, norm_grad)
    accept = inv_rho / jnp.maximum(norm_s2, 1e-30) > 1e-6 * norm_grad

    col_new = 1 + (lb["col"] % buffer_size)
    col = jnp.where(accept, col_new, lb["col"])
    mem = jnp.where(accept, jnp.minimum(lb["mem"] + 1, buffer_size),
                    lb["mem"])
    mat_s = {k: jnp.where(accept, lb["mat_s"][k].at[col_new].set(s[k]),
                          lb["mat_s"][k]) for k in ("xi", "psi")}
    mat_y = {k: jnp.where(accept, lb["mat_y"][k].at[col_new].set(yv[k]),
                          lb["mat_y"][k]) for k in ("xi", "psi")}
    rho = jnp.where(accept, lb["rho"].at[col_new].set(1.0 / inv_rho),
                    lb["rho"])
    skips = lb["skips"] + jnp.where(accept, 0, 1)

    gamma = inv_rho / jnp.maximum(norm_y2, 1e-30)
    hessian = jnp.where((gamma < 0) | (jnp.abs(gamma - lb["hessian"]) == 0),
                        1.0, gamma)

    # two-loop recursion on dir = -yvec
    d = {"xi": -yvec["xi"], "psi": -yvec["psi"]}
    n_cols = buffer_size + 1

    def loop1(i, carry):
        d, alphas = carry
        icol = col - i
        icol = jnp.where(icol < 0, mem + icol, icol)
        sk = {k: mat_s[k][icol] for k in d}
        yk = {k: mat_y[k][icol] for k in d}
        a = rho[icol] * dual_dot(sk, d, rep, axis_name)
        d = {k: d[k] - a * yk[k] for k in d}
        return d, alphas.at[icol].set(a)

    d, alphas = lax.fori_loop(0, mem, loop1,
                              (d, jnp.zeros((n_cols,), jnp.float32)))
    d = {k: hessian * d[k] for k in d}

    def loop2(j, d):
        i = mem - j              # reference iSize runs mem..1
        icol = col - i + 1
        icol = jnp.where(icol < 0, mem + icol, icol)
        sk = {k: mat_s[k][icol] for k in d}
        yk = {k: mat_y[k][icol] for k in d}
        b = rho[icol] * dual_dot(yk, d, rep, axis_name)
        scale = alphas[icol] - b
        return {k: d[k] + scale * sk[k] for k in d}

    d = lax.fori_loop(0, mem, loop2, d)
    lb_new = {"mat_s": mat_s, "mat_y": mat_y, "rho": rho, "col": col,
              "mem": mem, "skips": skips, "hessian": hessian}
    return lb_new, d


def _ls_apply(fa, step, state, w_dir, dirs, tau, *, prox_kwargs, step_size,
              axis_name):
    """One cumulative line-search application + re-evaluation."""
    x = state["x"] + tau * dirs["x"]
    u = state["u"] + tau * dirs["u"]
    w = {"xi": state["w"]["xi"] + tau * w_dir["xi"],
         "psi": state["w"]["psi"] + tau * w_dir["psi"]}
    prim = {"xi": state["prim"]["xi"] + tau * dirs["prim_xi"],
            "psi": state["prim"]["psi"] + tau * dirs["prim_psi"]}
    dual_xi, dual_psi, value_g = ss.prox_g(
        fa, prim["xi"], prim["psi"], w["xi"], w["psi"],
        axis_name=axis_name, **prox_kwargs)
    res = {"xi": prim["xi"] - dual_xi, "psi": prim["psi"] - dual_psi}
    val = value_fbe(fa, step, w, u, res, value_g, step_size=step_size,
                    axis_name=axis_name)
    new_state = {"x": x, "u": u, "w": w, "prim": prim,
                 "dual": {"xi": dual_xi, "psi": dual_psi},
                 "res": res, "value_g": value_g}
    return new_state, val


def tau_line_search(fa, step, state, w_dir, dirs, value_ref,
                    direction_value, *, prox_kwargs, step_size,
                    axis_name=None):
    """The reference's cumulative backtracking tau loop (:1280-1315).

    Applies tau increments 1, -1/2, +1/4-1/2... cumulatively while the
    FBE value keeps improving; the final worsening trial stays applied.
    Returns (state, |last tau increment|).
    """

    def cond(carry):
        istep, tau, st, val = carry
        return istep < LS_MAX_STEPS + 1

    def body(carry):
        istep, tau, st, _ = carry
        st_new, val = _ls_apply(fa, step, st, w_dir, dirs, tau,
                                prox_kwargs=prox_kwargs,
                                step_size=step_size, axis_name=axis_name)
        improved = val <= value_ref
        istep_new = jnp.where(improved, istep + 1,
                              jnp.int32(LS_MAX_STEPS + 1))
        tau_base = jnp.where(istep_new == 1, jnp.float32(-1.0), tau)
        tau_new = jnp.where(improved & (istep_new < LS_MAX_STEPS),
                            tau_base + 0.5 ** istep_new.astype(jnp.float32),
                            tau)
        return istep_new, tau_new, st_new, val

    def run_ls(state):
        init = (jnp.int32(0), jnp.float32(1.0), state, jnp.float32(0.0))
        _, tau, st, _ = lax.while_loop(cond, body, init)
        return st, jnp.abs(tau)

    positive = direction_value > 0
    tiny = jnp.abs(direction_value) < LS_TOLERANCE

    def no_ls(state):
        return state, jnp.where(positive, jnp.float32(1.0), jnp.float32(0.0))

    return lax.cond(positive | tiny, no_ls, run_ls, state)


def fbe_line_search(fa, step, state, grad, lbfgs_dir, value_ref, *,
                    prefix_stages, prox_kwargs, step_size, axis_name=None):
    """computeLineSearchLbfgsUpdate (src/SmpcController.cu:1250-1320)."""
    h = oracle(fa, lbfgs_dir["xi"], lbfgs_dir["psi"],
               prefix_stages=prefix_stages, axis_name=axis_name)
    dirs = {"x": h["x"], "u": h["u"], "prim_xi": h["prim_xi"],
            "prim_psi": h["prim_psi"]}
    dval = dual_dot(grad, lbfgs_dir, fa["rep"], axis_name)
    return tau_line_search(fa, step, state, lbfgs_dir, dirs, value_ref,
                           dval, prox_kwargs=prox_kwargs,
                           step_size=step_size, axis_name=axis_name)


def ame_line_search(fa, step, state, lbfgs_dir, value_ref, *,
                    prefix_stages, prox_kwargs, step_size, axis_name=None):
    """computeLineSearchAmeLbfgsUpdate (src/SmpcController.cu:1326-1414).

    First takes the gradient (residual) step unconditionally, then runs
    the tau loop along the combined direction d = lbfgsDir - step * res.
    """
    rep = fa["rep"]
    res = state["res"]
    dval = -dual_dot(res, lbfgs_dir, rep, axis_name)

    hres = oracle(fa, res["xi"], res["psi"], prefix_stages=prefix_stages,
                  axis_name=axis_name)
    st = dict(state)
    st["w"] = {"xi": state["w"]["xi"] + step_size * res["xi"],
               "psi": state["w"]["psi"] + step_size * res["psi"]}
    st["x"] = state["x"] + step_size * hres["x"]
    st["u"] = state["u"] + step_size * hres["u"]
    st["prim"] = {"xi": state["prim"]["xi"] + step_size * hres["prim_xi"],
                  "psi": state["prim"]["psi"] +
                  step_size * hres["prim_psi"]}

    comb = {"xi": lbfgs_dir["xi"] - step_size * res["xi"],
            "psi": lbfgs_dir["psi"] - step_size * res["psi"]}
    hcomb = oracle(fa, comb["xi"], comb["psi"], prefix_stages=prefix_stages,
                   axis_name=axis_name)
    dirs = {"x": hcomb["x"], "u": hcomb["u"], "prim_xi": hcomb["prim_xi"],
            "prim_psi": hcomb["prim_psi"]}
    return tau_line_search(fa, step, st, comb, dirs, value_ref, dval,
                           prox_kwargs=prox_kwargs, step_size=step_size,
                           axis_name=axis_name)


def make_solver(*, algorithm: str, prefix_stages: tuple, inv_step: float,
                step_size: float, penalty_state: float,
                penalty_safety: float, xs_upper: float,
                max_iterations: int, lbfgs_buffer_size: int,
                axis_name: str | None = None, project_control: bool = True,
                tolerance: float | None = None,
                trace_control: bool = False):
    """Build the jittable FBE or NAMA solve function fn(fa, step, y0=None).

    Beyond reference parity (the reference treats the quasi-Newton
    algorithms uniformly with APG behind one dispatch but always
    cold-starts and always runs the full budget,
    src/SmpcController.cu:63-71,1607-1667):

    * ``y0``: optional dual warm start {"xi", "psi"} — the previous
      receding-horizon solve's ``out["y"]``.  The L-BFGS buffer starts
      fresh (curvature pairs from the previous problem are stale).
    * ``tolerance``: early termination on the primal-infeasibility
      diagnostic via ``lax.while_loop`` (diagnostic traces are
      zero-padded past the termination point).
    """
    is_fbe = algorithm == ALGORITHM_FBE
    if not is_fbe and algorithm != ALGORITHM_NAMA:
        raise ValueError(f"unknown quasi-Newton algorithm {algorithm}")
    n_cols = lbfgs_buffer_size + 1
    prox_kwargs = dict(inv_step=inv_step, penalty_state=penalty_state,
                       penalty_safety=penalty_safety, xs_upper=xs_upper)

    def prox(fa, prim, w):
        dual_xi, dual_psi, value_g = ss.prox_g(
            fa, prim["xi"], prim["psi"], w["xi"], w["psi"],
            axis_name=axis_name, **prox_kwargs)
        return {"xi": dual_xi, "psi": dual_psi}, value_g

    def one_iteration(fa, step, carry, it):
        w = carry["w"]
        sol = ss.solve_step(
            fa, w["xi"], w["psi"], step["beta"], step["uhat"], step["e"],
            step["x0"], step["prev_u"], step["prev_uhat"],
            prefix_stages=prefix_stages, axis_name=axis_name)
        prim = {"xi": sol["prim_xi"], "psi": sol["prim_psi"]}
        dual, value_g = prox(fa, prim, w)
        res = {"xi": prim["xi"] - dual["xi"],
               "psi": prim["psi"] - dual["psi"]}

        if is_fbe:
            hdir = oracle(fa, -res["xi"], -res["psi"],
                          prefix_stages=prefix_stages, axis_name=axis_name)
            yvec = {"xi": -res["xi"] + step_size * hdir["prim_xi"],
                    "psi": -res["psi"] + step_size * hdir["prim_psi"]}
        else:
            yvec = {"xi": -res["xi"], "psi": -res["psi"]}

        state = {"x": sol["x"], "u": sol["u"], "w": w, "prim": prim,
                 "dual": dual, "res": res, "value_g": value_g}

        def with_qn(args):
            state, lb = args
            value = value_fbe(fa, step, state["w"], state["u"],
                              state["res"], state["value_g"],
                              step_size=step_size, axis_name=axis_name)
            lb_new, lbfgs_dir = lbfgs_update_and_direction(
                fa, lb, carry["y"], carry["y_prev"], yvec,
                carry["yvec_prev"], buffer_size=lbfgs_buffer_size,
                axis_name=axis_name)
            if is_fbe:
                st, tau = fbe_line_search(
                    fa, step, state, yvec, lbfgs_dir, value,
                    prefix_stages=prefix_stages, prox_kwargs=prox_kwargs,
                    step_size=step_size, axis_name=axis_name)
            else:
                st, tau = ame_line_search(
                    fa, step, state, lbfgs_dir, value,
                    prefix_stages=prefix_stages, prox_kwargs=prox_kwargs,
                    step_size=step_size, axis_name=axis_name)
            return st, lb_new, tau, value

        def without_qn(args):
            state, lb = args
            return state, lb, jnp.float32(0.0), jnp.float32(0.0)

        state, lb, tau, value = lax.cond(
            it > 0, with_qn, without_qn, (state, carry["lbfgs"]))

        # dual update (src/SmpcController.cu:865-880)
        y_new = {"xi": state["w"]["xi"] + step_size * state["res"]["xi"],
                 "psi": state["w"]["psi"] + step_size * state["res"]["psi"]}
        infeas = ss.signed_max_abs(state["res"]["xi"], state["res"]["psi"],
                                   axis_name)
        mag = ss.max_abs_residual(state["res"]["xi"], state["res"]["psi"],
                                  axis_name)
        new_carry = {
            "y": y_new, "y_prev": carry["y"], "yvec_prev": yvec,
            "w": y_new, "lbfgs": lb,
            "x": state["x"], "u": state["u"], "v": sol["v"],
        }
        return new_carry, (infeas, value, tau, mag)

    def init_carry(fa, step, y0):
        N, ns = step["beta"].shape[:2]
        nx = fa["d1"].shape[-1]
        nu = fa["g"].shape[-1]
        nv = fa["invWbar"].shape[0]
        zx = jnp.zeros((N, ns, 2 * nx), jnp.float32)
        zp = jnp.zeros((N, ns, nu), jnp.float32)
        zero_dual = {"xi": zx, "psi": zp}
        if y0 is None:
            y0 = zero_dual
        lb0 = {
            "mat_s": {"xi": jnp.zeros((n_cols, N, ns, 2 * nx), jnp.float32),
                      "psi": jnp.zeros((n_cols, N, ns, nu), jnp.float32)},
            "mat_y": {"xi": jnp.zeros((n_cols, N, ns, 2 * nx), jnp.float32),
                      "psi": jnp.zeros((n_cols, N, ns, nu), jnp.float32)},
            "rho": jnp.zeros((n_cols,), jnp.float32),
            "col": jnp.int32(0), "mem": jnp.int32(0),
            "skips": jnp.int32(0), "hessian": jnp.float32(1.0),
        }
        return {
            "y": y0, "y_prev": y0, "yvec_prev": zero_dual,
            "w": y0, "lbfgs": lb0,
            "x": jnp.zeros((N, ns, nx), jnp.float32),
            "u": jnp.zeros((N, ns, nu), jnp.float32),
            "v": jnp.zeros((N, ns, nv), jnp.float32),
        }

    def finish(fa, carry, infeas, values, taus, iters):
        if project_control:
            lo, hi = ss.root_control_bounds(fa)
            u0 = jnp.clip(carry["u"][0, 0], lo, hi)
        else:
            u0 = carry["u"][0, 0]
        return {
            "control": u0, "x": carry["x"], "u": carry["u"],
            "v": carry["v"], "y": carry["y"],
            "primal_infeasibility": infeas,
            "value_fbe": values, "tau": taus,
            "iterations": iters,
        }

    if tolerance is None:
        def run(fa, step, y0=None):
            carry = init_carry(fa, step, y0)

            def body(c, it):
                c, (inf, val, tau, _) = one_iteration(fa, step, c, it)
                out = ((inf, val, tau, c["u"][0, 0]) if trace_control
                       else (inf, val, tau))
                return c, out

            carry, traces = lax.scan(
                body, carry, jnp.arange(max_iterations))
            infeas, values, taus = traces[:3]
            out = finish(fa, carry, infeas, values, taus,
                         jnp.int32(max_iterations))
            if trace_control:
                out["control_trace"] = traces[3]
            return out
    else:
        def run(fa, step, y0=None):
            carry = init_carry(fa, step, y0)
            zeros = jnp.zeros((max_iterations,), jnp.float32)

            def cond(state):
                it, c, traces, last = state
                return (it < max_iterations) & (last > tolerance)

            def body(state):
                it, c, traces, _ = state
                infs, vals, taus = traces
                c, (inf, val, tau, mag) = one_iteration(fa, step, c, it)
                traces = (infs.at[it].set(inf), vals.at[it].set(val),
                          taus.at[it].set(tau))
                return it + 1, c, traces, mag

            it, carry, (infs, vals, taus), _ = lax.while_loop(
                cond, body, (jnp.int32(0), carry, (zeros, zeros, zeros),
                             jnp.float32(jnp.inf)))
            return finish(fa, carry, infs, vals, taus, it)

    return run


def make_solver_batch(**kwargs):
    """Batched FBE/NAMA: B independent instances in one program
    (``jax.vmap`` over the step dict's leading axis; factor arrays
    shared).

    Note: under vmap the backtracking line searches run in masked
    lockstep (every instance evaluates until all are done, converged
    lanes keep their values via select), so per-instance trajectories
    can differ from a standalone solve at the f32 rounding level
    (~1e-4 on controls) — well inside the reference's golden
    tolerances (src/test/TestSmpcController.cu:31-43).
    """
    run = make_solver(**kwargs)
    v_cold = jax.vmap(lambda fa, s: run(fa, s), in_axes=(None, 0))
    v_warm = jax.vmap(run, in_axes=(None, 0, 0))

    def run_batch(fa, steps, y0=None):
        return v_cold(fa, steps) if y0 is None else v_warm(fa, steps, y0)

    return run_batch


def make_solver_batch_shared(**kwargs):
    """Batched FBE/NAMA over a SHARED forecast: fn(fa, base, inst[, y0]).

    Same device-side batch assembly contract as
    ``apg.make_apg_batch_shared`` (Engine.prepare_step_shared): the host
    ships O(tree) + O(B nu) bytes per control step instead of O(B tree).
    """
    from rapidnet_jax.solver.apg import expand_shared_step

    run = make_solver(**kwargs)

    def one(fa, base, x0, pu, puh, dlt, y0=None):
        step = expand_shared_step(base, x0, pu, puh, dlt)
        return run(fa, step) if y0 is None else run(fa, step, y0)

    v_cold = jax.vmap(one, in_axes=(None, None, 0, 0, 0, 0))
    v_warm = jax.vmap(one, in_axes=(None, None, 0, 0, 0, 0, 0))

    def run_batch(fa, base, inst, y0=None):
        args = (fa, base, inst["x0"], inst["prev_u"],
                inst["prev_uhat"], inst["delta_beta0"])
        return v_cold(*args) if y0 is None else v_warm(*args, y0)

    return run_batch
