"""Dual accelerated proximal gradient (APG) — the default online solver.

Reference: ``SmpcController::algorithmApg`` (src/SmpcController.cu:
1500-1525) with the Nesterov theta sequence and extrapolation of
src/SmpcController.cu:535-557.  The reference launches ~hundreds of
cuBLAS calls + kernels per iteration with two host syncs (prox norm,
infeasibility); here the *entire* iteration loop is one ``lax.scan`` /
``lax.while_loop`` inside one jitted XLA program — zero host
round-trips.

Beyond reference parity:
* ``warm_start``: pass the previous solve's dual pair as ``y0`` (the
  reference always cold-starts, src/SmpcController.cu:425-432).
  MEASURED (tools/warm_start_study.py): on this
  problem family dual warm starting does NOT improve closed-loop
  accuracy-per-budget — warm and cold trajectories agree to <=0.01%
  at every budget from 100 to 5000 iterations.  The mechanism is
  supported for checkpoint/resume continuity, not as an accelerator.
* ``tolerance``: early termination on the primal-infeasibility
  diagnostic, via ``lax.while_loop`` (the reference always runs the
  full budget).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from rapidnet_jax.solver import solve_step as ss

# Unrolling the iteration scan trades compile time for less loop
# bookkeeping per iteration (tiny-op regime).  Not yet tuned on a GPU.
ITER_UNROLL = 4


def apg_oracle(fa, step, w_xi, w_psi, *, prefix_stages, inv_step,
               step_size, penalty_state, penalty_safety, xs_upper,
               axis_name=None):
    """One dual-gradient step at an injected accelerated dual w.

    The body of every APG iteration — solve step, prox of g, fixed-point
    residual (Hz - t, src/SmpcController.cu:839-850) and dual update
    (y+ = w + step (Hz - t), :854-881) — exposed as a unit so golden
    fixture tests can inject the accelerated dual and compare every
    intermediate, mirroring the reference's protected-method test
    pattern (TestSmpcController::testFixedPointResidual /
    testDualUpdate, src/test/TestSmpcController.cu:291-398).

    Returns the solve-step outputs plus dual_xi/dual_psi (prox),
    res_xi/res_psi (fixed-point residual), value_g and the updated
    dual pair y_xi/y_psi.
    """
    sol = ss.solve_step(
        fa, w_xi, w_psi, step["beta"], step["uhat"], step["e"],
        step["x0"], step["prev_u"], step["prev_uhat"],
        prefix_stages=prefix_stages, axis_name=axis_name)
    dual_xi, dual_psi, value_g = ss.prox_g(
        fa, sol["prim_xi"], sol["prim_psi"], w_xi, w_psi,
        inv_step=inv_step, penalty_state=penalty_state,
        penalty_safety=penalty_safety, xs_upper=xs_upper,
        axis_name=axis_name)
    res_xi = sol["prim_xi"] - dual_xi
    res_psi = sol["prim_psi"] - dual_psi
    return dict(sol, dual_xi=dual_xi, dual_psi=dual_psi,
                value_g=value_g, res_xi=res_xi, res_psi=res_psi,
                y_xi=w_xi + step_size * res_xi,
                y_psi=w_psi + step_size * res_psi)


def make_apg(*, prefix_stages: tuple, inv_step: float, step_size: float,
             penalty_state: float, penalty_safety: float, xs_upper: float,
             max_iterations: int, axis_name: str | None = None,
             project_control: bool = True, tolerance: float | None = None,
             trace_control: bool = False):
    """Build the jittable APG solve function.

    Returns fn(fa, step, y0=None) -> dict with final x, u, v, duals and
    the per-iteration primal-infeasibility trace (zero-padded past the
    termination point when ``tolerance`` is set).

    ``fa`` is the factor-array dict (fan layout), ``step`` the per-step
    dict with beta/uhat/e/x0/prev_u/prev_uhat, ``y0`` an optional dual
    warm start {"xi": ..., "psi": ...}.
    """
    oracle_kw = dict(prefix_stages=prefix_stages, inv_step=inv_step,
                     step_size=step_size, penalty_state=penalty_state,
                     penalty_safety=penalty_safety, xs_upper=xs_upper,
                     axis_name=axis_name)

    def one_iteration(fa, step, carry):
        y, z, th0, th1 = (carry["y"], carry["z"], carry["th0"],
                          carry["th1"])
        lam = th1 * (1.0 / th0 - 1.0)
        # w = (1+lam) y - lam y_prev = y + lam z   (dual extrapolation,
        # src/SmpcController.cu:544-552)
        w_xi = y["xi"] + lam * z["xi"]
        w_psi = y["psi"] + lam * z["psi"]

        o = apg_oracle(fa, step, w_xi, w_psi, **oracle_kw)

        y_new = {"xi": o["y_xi"], "psi": o["y_psi"]}
        # z+ = y+ - y = lam z + step res
        z_new = {k: y_new[k] - y[k] for k in y}
        th0_new = th1
        th1_new = 0.5 * (jnp.sqrt(th1 ** 4 + 4.0 * th1 ** 2) - th1 ** 2)
        infeas = ss.signed_max_abs(o["res_xi"], o["res_psi"], axis_name)
        mag = ss.max_abs_residual(o["res_xi"], o["res_psi"], axis_name)
        new_carry = {"y": y_new, "z": z_new, "th0": th0_new,
                     "th1": th1_new, "x": o["x"], "u": o["u"],
                     "v": o["v"]}
        return new_carry, (infeas, mag)

    def init_carry(fa, step, y0):
        shp = step["beta"].shape[:2]   # (N, ns)
        nxd = fa["d1"].shape[-1]
        nu = fa["g"].shape[-1]
        if y0 is None:
            y0 = {"xi": jnp.zeros(shp + (2 * nxd,), jnp.float32),
                  "psi": jnp.zeros(shp + (nu,), jnp.float32)}
        z0 = {k: jnp.zeros_like(v) for k, v in y0.items()}
        return {
            "y": y0, "z": z0,
            "th0": jnp.float32(1.0), "th1": jnp.float32(1.0),
            "x": jnp.zeros(shp + (nxd,), jnp.float32),
            "u": jnp.zeros(shp + (nu,), jnp.float32),
            "v": jnp.zeros(shp + (fa["invWbar"].shape[0],), jnp.float32),
        }

    def finish(fa, carry, infeas, iters):
        # final control = stage-0 u of the last solve, projected onto the
        # (preconditioned) node-0 control bounds — reference parity with
        # src/SmpcController.cu:1647-1649.  (Skipped in sharded mode where
        # slot 0 lives on one device; the caller projects instead.)
        if project_control:
            lo, hi = ss.root_control_bounds(fa)
            u0 = jnp.clip(carry["u"][0, 0], lo, hi)
        else:
            u0 = carry["u"][0, 0]
        return {
            "control": u0,
            "x": carry["x"], "u": carry["u"], "v": carry["v"],
            "y": carry["y"],
            "primal_infeasibility": infeas,
            "iterations": iters,
        }

    if tolerance is None:
        def run(fa, step, y0=None):
            carry = init_carry(fa, step, y0)

            def body(c, _):
                c, (inf, _) = one_iteration(fa, step, c)
                out = (inf, c["u"][0, 0]) if trace_control else inf
                return c, out

            carry, traces = lax.scan(body, carry, None,
                                     length=max_iterations,
                                     unroll=ITER_UNROLL)
            if trace_control:
                infeas, u_trace = traces
            else:
                infeas = traces
            out = finish(fa, carry, infeas, jnp.int32(max_iterations))
            if trace_control:
                # per-iteration stage-0 control (unprojected): the
                # time-to-solution diagnostic — iterations until u0
                # stabilises at the budget answer (bench.py)
                out["control_trace"] = u_trace
            return out
    else:
        def run(fa, step, y0=None):
            carry = init_carry(fa, step, y0)
            infs0 = jnp.zeros((max_iterations,), jnp.float32)

            def cond(state):
                it, c, infs, last = state
                return (it < max_iterations) & (last > tolerance)

            def body(state):
                it, c, infs, _ = state
                c, (inf, mag) = one_iteration(fa, step, c)
                return it + 1, c, infs.at[it].set(inf), mag

            it, carry, infs, _ = lax.while_loop(
                cond, body,
                (jnp.int32(0), carry, infs0, jnp.float32(jnp.inf)))
            return finish(fa, carry, infs, it)

    return run


def make_apg_batch(**kwargs):
    """Batched APG: solve B independent problem instances in one XLA
    program (``jax.vmap`` over the step dict's leading axis).

    The factor arrays are shared (one network/tree, many initial
    conditions — batched receding-horizon runs, Monte-Carlo studies,
    scenario-of-scenarios evaluations).  Batching gives the device
    larger matmuls than one instance's tiny matrices and amortises the
    fixed per-program overhead.

    Returns fn(fa, steps, y0=None): every leaf of ``steps`` (and of the
    warm-start ``y0``, when given) carries a leading batch axis.
    """
    run = make_apg(**kwargs)
    v_cold = jax.vmap(lambda fa, s: run(fa, s), in_axes=(None, 0))
    v_warm = jax.vmap(run, in_axes=(None, 0, 0))

    def run_batch(fa, steps, y0=None):
        return v_cold(fa, steps) if y0 is None else v_warm(fa, steps, y0)

    return run_batch


def expand_shared_step(base: dict, x0, prev_u, prev_uhat, delta_beta0):
    """One instance's step dict from the shared base + its vectors
    (Engine.prepare_step_shared): only the root-stage beta differs."""
    return dict(base, x0=x0, prev_u=prev_u, prev_uhat=prev_uhat,
                beta=base["beta"].at[0].add(delta_beta0[None, :]))


def make_apg_batch_shared(**kwargs):
    """Batched APG over a SHARED forecast: fn(fa, base, inst[, y0]).

    ``base`` holds the unbatched fan arrays; ``inst`` the per-instance
    {x0, prev_u, prev_uhat, delta_beta0} (Engine.prepare_step_shared).
    The batched steps are assembled inside the program, so the host
    ships O(tree) + O(B nu) bytes per control step instead of
    O(B tree) — the main staging cost of batched closed loops.
    """
    run = make_apg(**kwargs)

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
