"""The dual-gradient oracle: one jitted backward/forward tree sweep.

Reference counterpart: ``SmpcController::solveStep``
(src/SmpcController.cu:563-755) — a stage loop of ~10 batched cuBLAS
GEMMs per stage plus child-sum / ancestor-broadcast kernels
(src/Utilities.cu:142-201), and ``computeHessianOracalGlobalFbe``
(src/SmpcController.cu:884-1055) which is the same recursion with the
affine terms removed.

Design (fan layout, see model/scenario_tree.py):

*  backward sweep = ``lax.scan`` (reverse) over the non-branching tail
   where child->parent aggregation is slot-identity, plus an unrolled
   prefix (<= final branching stage, typically 1-3 stages) where
   aggregation is a dense one-hot matmul ``C_s @ q``;
*  forward sweep = one uniform ``lax.scan``: in fan layout the ancestor
   value lives at the *same slot*, so there are no gathers at all;
*  per-stage math collapses to two shared-matrix matmuls
   ``(ns,nx)@(nx,nv)`` and ``(ns,nu)@(nu,nv)`` (backward) and two
   ``(ns,nv)@(nv,nu)``/``(ns,nu)@(nu,nx)`` (forward), with everything
   else elementwise — XLA fuses the elementwise chains.

The whole sweep is shape-static; under `jit` the stage scan compiles to
a single XLA while loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

# Match the reference's true-f32 numerics (cuBLAS Sgemm).  On a GPU an
# f32 product without a precision argument may run in TF32 on the
# tensor cores; HIGHEST keeps it in true f32, off the tensor cores.
# Every device matmul of the solve path goes through _mm or passes
# this constant.
MM_PRECISION = lax.Precision.HIGHEST

# Stage scans are unrolled to amortise XLA loop overhead: the per-stage
# work is tiny (a few (ns, k)@(k, m) matmuls), so loop bookkeeping is a
# measurable fraction of the sweep.  Not yet tuned on a GPU.
STAGE_UNROLL = 8

# Sweep implementation switch.  For small trees the stage recursions run
# as batched matmuls + log-depth lax.cumsum (minimal kernel count); for
# large trees the cumsum's O(log N) full-array passes dominate HBM
# traffic, and a sequential lax.scan over stages — one slice read/write
# per stage, per-stage (ns, k)@(k, m) matmuls that are already large
# at ns >= a few hundred — wins.  Threshold on the per-stage row count;
# not yet tuned on a GPU.
SCAN_MIN_NS = 256


def _mm(a, b):
    return jnp.matmul(a, b, precision=MM_PRECISION)


def _rev_cumsum(a):
    """Reverse (suffix) inclusive cumulative sum along the stage axis.

    Implements the sequential tail recursions as one data-parallel op
    instead of N sequential per-stage kernels.
    """
    return lax.cumsum(a, axis=0, reverse=True)


def backward_sweep(fa: dict, w_xi: jnp.ndarray, w_psi: jnp.ndarray,
                   beta: jnp.ndarray, *, prefix_stages: tuple,
                   axis_name: str | None = None) -> jnp.ndarray:
    """Backward substitution: dual gradient recursion over stages N-1..0.

    The reference sweeps stages serially with ~10 batched cuBLAS calls
    per stage (src/SmpcController.cu:593-672).  In fan layout the
    non-branching tail recursion is *affine with stage-invariant
    matrices*:

        t_s     = tb_s + t_{s+1}                 (tb from duals only)
        inner_s = (beta_s + h_s + t_s Bb') + inner_{s+1}
        v_s     = nhp_s * inner_s invWbar'

    so the whole tail collapses to two batched (N*ns, k)@(k, m) matmuls
    and two stage-axis cumulative sums — no sequential matmul chain.
    Only the short branching prefix (<= final branching stage) is
    unrolled, with dense one-hot child->parent aggregation matmuls.

    Args:
      fa: factor arrays (fan layout slices d1/d2/g/nhp + shared Bb/L/invWbar).
      w_xi:  (N, ns, 2nx) dual xi input (accelerated dual).
      w_psi: (N, ns, nu) dual psi input.
      beta:  (N, ns, nv) linear cost term (zeros for the Hessian oracle).
      prefix_stages: static descending tuple of stages whose child->parent
        handoff needs aggregation (from ScenarioTree.prefix_agg).
    Returns:
      v: (N, ns, nv) candidate null-space controls per stage.
    """
    Bb, L, invWbar = fa["Bb"], fa["L"], fa["invWbar"]
    nx = Bb.shape[1]

    def stage_math(q, r, xs):
        d1, d2, g, nhp, beta_s, xi, psi = xs
        sigma = beta_s + r
        t = d1 * xi[..., :nx] + d2 * xi[..., nx:] + q
        inner = sigma + _mm(t, Bb.T) + _mm(g * psi, L)
        v = nhp * _mm(inner, invWbar.T)
        return t, inner, v

    first_prefix = prefix_stages[0] + 1 if prefix_stages else 0
    N = w_xi.shape[0]
    ns = w_xi.shape[1]
    nv = invWbar.shape[0]

    if first_prefix < N and ns >= SCAN_MIN_NS:
        # --- large trees: sequential stage scan (one slice read/write
        # per stage — minimal memory traffic; matmuls large at this ns)
        xs = (fa["d1"][first_prefix:], fa["d2"][first_prefix:],
              fa["g"][first_prefix:], fa["nhp"][first_prefix:],
              beta[first_prefix:], w_xi[first_prefix:],
              w_psi[first_prefix:])

        def scan_body(carry, xs_s):
            t, inner, v_s = stage_math(*carry, xs_s)
            return (t, inner), v_s

        init = (jnp.zeros((ns, nx), w_xi.dtype),
                jnp.zeros((ns, nv), w_xi.dtype))
        (q, r), v_tail = lax.scan(scan_body, init, xs, reverse=True,
                                  unroll=min(STAGE_UNROLL,
                                             N - first_prefix))
    elif first_prefix < N:
        # --- batched tail: precompute dual-only terms over all stages
        tb = (fa["d1"][first_prefix:] * w_xi[first_prefix:, ..., :nx] +
              fa["d2"][first_prefix:] * w_xi[first_prefix:, ..., nx:])
        h = _mm(fa["g"][first_prefix:] * w_psi[first_prefix:], L)
        t_tail = _rev_cumsum(tb)
        a_tail = beta[first_prefix:] + h + _mm(t_tail, Bb.T)
        inner_tail = _rev_cumsum(a_tail)
        v_tail = fa["nhp"][first_prefix:] * _mm(inner_tail, invWbar.T)
        q, r = t_tail[0], inner_tail[0]
    else:
        v_tail = jnp.zeros((0, ns, nv), w_xi.dtype)
        q = jnp.zeros((ns, nx), w_xi.dtype)
        r = jnp.zeros((ns, nv), w_xi.dtype)

    # unrolled branching prefix with aggregation matmuls
    v_prefix = []
    for s in range(first_prefix - 1, -1, -1):
        xs = (fa["d1"][s], fa["d2"][s], fa["g"][s], fa["nhp"][s],
              beta[s], w_xi[s], w_psi[s])
        q, r, v_s = stage_math(q, r, xs)
        v_prefix.append(v_s)
        if s > 0 and s in prefix_stages:
            # child -> parent aggregation in factored form
            # C = Bp @ Cp over the DISTINCT parents (scenario_tree.py):
            # sharded, only the (Rp, nx+nv) parent block crosses shards
            # (one psum per stage) — Rp = nodesPerStage[s-1], a few
            # nodes at the shallow prefix stages — instead of
            # all-gathering the full (ns, nx)+(ns, nv) slot blocks
            # (measured 2.62 MB/iter -> 33 kB/iter at the 1024-scenario
            # ladder config; docs/multihost.md).
            Cp, Bp = fa["prefix_Cp"][s], fa["prefix_Bp"][s]
            parents = jnp.concatenate([_mm(Cp, q), _mm(Cp, r)], axis=-1)
            if axis_name is not None:
                parents = lax.psum(parents, axis_name)
            q = _mm(Bp, parents[:, :nx])
            r = _mm(Bp, parents[:, nx:])
    if v_prefix:
        v_prefix = jnp.stack(v_prefix[::-1])
        v = jnp.concatenate([v_prefix, v_tail], axis=0)
    else:
        v = v_tail
    return v


def forward_sweep(fa: dict, v: jnp.ndarray, uhat: jnp.ndarray,
                  e: jnp.ndarray, x0: jnp.ndarray, prev_u: jnp.ndarray,
                  prev_uhat: jnp.ndarray):
    """Forward substitution + primal H application.

    u_s = uhat_s + L v_s + (u_{s-1} - uhat_{s-1});  x_s = x_{s-1} + e_s + B u_s
    (reference src/SmpcController.cu:678-741; in fan layout the ancestor
    terms live at the same slot so the scan body is gather-free).

    Returns x (N,ns,nx), u (N,ns,nu), prim_xi (N,ns,2nx), prim_psi (N,ns,nu).
    """
    L, B = fa["L"], fa["B"]

    # du_s = u_s - uhat_s satisfies du_s = v_s L' + du_{s-1}: an
    # inclusive stage cumsum of the (batched) v L' matmul.  Likewise
    # x_s = x_{s-1} + e_s + u_s B' is a cumsum of e + u B'.  Two big
    # matmuls + two log-depth cumsums replace the serial stage loop
    # for small trees; large trees use a sequential stage scan (see
    # SCAN_MIN_NS).
    N, ns = v.shape[0], v.shape[1]
    if ns >= SCAN_MIN_NS:
        def scan_body(carry, xs_s):
            du_p, x_p = carry
            v_s, uhat_s, e_s = xs_s
            du_s = du_p + _mm(v_s, L.T)
            u_s = uhat_s + du_s
            x_s = x_p + e_s + _mm(u_s, B.T)
            return (du_s, x_s), (x_s, u_s)

        init = (jnp.broadcast_to(prev_u - prev_uhat,
                                 (ns, L.shape[0])).astype(v.dtype),
                jnp.broadcast_to(x0, (ns, B.shape[0])).astype(v.dtype))
        _, (x, u) = lax.scan(scan_body, init, (v, uhat, e),
                             unroll=min(STAGE_UNROLL, N))
    else:
        du = lax.cumsum(_mm(v, L.T), axis=0) + (prev_u - prev_uhat)
        u = uhat + du
        x = lax.cumsum(e + _mm(u, B.T), axis=0) + x0
    prim_xi = jnp.concatenate([fa["d1"] * x, fa["d2"] * x], axis=-1)
    prim_psi = fa["g"] * u
    return x, u, prim_xi, prim_psi


def solve_step(fa: dict, w_xi, w_psi, beta, uhat, e, x0, prev_u, prev_uhat,
               *, prefix_stages: tuple, axis_name: str | None = None):
    """Full dual-gradient oracle (backward + forward + primal).

    With beta/uhat/e/x0/prev_* zeroed this is exactly the Hessian oracle
    of the FBE/NAMA algorithms (src/SmpcController.cu:884-1055).
    """
    v = backward_sweep(fa, w_xi, w_psi, beta,
                       prefix_stages=prefix_stages, axis_name=axis_name)
    x, u, prim_xi, prim_psi = forward_sweep(
        fa, v, uhat, e, x0, prev_u, prev_uhat)
    return {"v": v, "x": x, "u": u,
            "prim_xi": prim_xi, "prim_psi": prim_psi}


def _masked_sumsq(x, rep, axis_name):
    """Sum of squares counting each tree node once (rep de-duplicates)."""
    s = jnp.sum(rep[..., None] * x * x)
    if axis_name is not None:
        s = lax.psum(s, axis_name)
    return s


def prox_g(fa: dict, prim_xi, prim_psi, w_xi, w_psi, *, inv_step: float,
           penalty_state: float, penalty_safety: float, xs_upper: float,
           axis_name: str | None = None):
    """Proximal operator of the constraint function g on the dual pair.

    Reference: SmpcController::proximalFunG (src/SmpcController.cu:759-835):
    box projections on state/control plus soft two-norm penalties on the
    state-box and safety-level violations (a global-norm shrink step).

    Returns dual_xi, dual_psi and the g-cost pieces used by the FBE value.
    """
    nx = fa["Bb"].shape[1]
    rep = fa["rep"]
    dual_xi = prim_xi + inv_step * w_xi
    dual_psi = prim_psi + inv_step * w_psi

    pre1 = dual_xi[..., :nx]
    pre2 = dual_xi[..., nx:]
    box1 = jnp.clip(pre1, fa["xmin"], fa["xmax"])
    box2 = jnp.clip(pre2, fa["xs"], xs_upper)
    diff1 = pre1 - box1
    diff2 = pre2 - box2

    dist1 = jnp.sqrt(_masked_sumsq(diff1, rep, axis_name))
    thresh1 = inv_step * penalty_state
    shrink1 = jnp.where(dist1 > thresh1, 1.0 - thresh1 /
                        jnp.maximum(dist1, 1e-30), 0.0)
    out1 = box1 + shrink1 * diff1

    dist2 = jnp.sqrt(_masked_sumsq(diff2, rep, axis_name))
    thresh2 = inv_step * penalty_safety
    shrink2 = jnp.where(dist2 > thresh2, 1.0 - thresh2 /
                        jnp.maximum(dist2, 1e-30), 0.0)
    out2 = box2 + shrink2 * diff2

    dual_xi = jnp.concatenate([out1, out2], axis=-1)
    dual_psi = jnp.clip(dual_psi, fa["umin"], fa["umax"])

    # g-cost pieces (used only by the FBE/NAMA value function,
    # src/SmpcController.cu:798-825): penalty * distance-from-set of the
    # post-prox point.
    gd1 = jnp.sqrt(_masked_sumsq(out1 - jnp.clip(out1, fa["xmin"],
                                                 fa["xmax"]), rep, axis_name))
    gd2 = jnp.sqrt(_masked_sumsq(out2 - jnp.clip(out2, fa["xs"], xs_upper),
                                 rep, axis_name))
    value_g = (jnp.where(shrink1 > 0, penalty_state * gd1, 0.0) +
               jnp.where(shrink2 > 0, penalty_safety * gd2, 0.0))
    return dual_xi, dual_psi, value_g


def root_control_bounds(fa: dict):
    """Bounds for the final control projection — PHYSICAL units.

    Deliberate deviation from the reference: projectionBox at
    src/SmpcController.cu:1649 clips the physical u0 onto bounds that
    preconditionConstraintU has scaled in place by sqrt(p)*precnd
    (src/Engine.cu:447-448) — invisible with the shipped near-identity
    root-stage preconditioners, but with a tuned preconditioner whose
    root g << 1 it clips every control to ~0 (and with g > 1 it admits
    out-of-bounds controls; both observed on the real Barcelona
    preconditioner and the auto-tuned dwn.mat problem).  Like the
    reference's prevU copy-paste bug, we do not replicate it:
    ``umin_phys``/``umax_phys`` carry the network's physical bounds.
    """
    if "umin_phys" in fa:
        return fa["umin_phys"], fa["umax_phys"]
    return fa["umin"][0, 0], fa["umax"][0, 0]


def signed_max_abs(res_xi, res_psi, axis_name: str | None = None):
    """Primal infeasibility diagnostic.

    Reference quirk preserved (src/SmpcController.cu:1480-1496): Isamax
    picks the entry with max |value| but the *signed* value is returned,
    and the max of the xi/psi representatives is taken.
    """
    fx = res_xi.reshape(-1)
    fp = res_psi.reshape(-1)
    vx = fx[jnp.argmax(jnp.abs(fx))]
    vp = fp[jnp.argmax(jnp.abs(fp))]
    if axis_name is not None:
        # per dual block, the signed value of the globally max-|.| entry
        # (each shard contributes its local champion), then signed max —
        # exactly the single-device semantics
        ax = lax.all_gather(vx, axis_name)
        ap = lax.all_gather(vp, axis_name)
        vx = ax[jnp.argmax(jnp.abs(ax))]
        vp = ap[jnp.argmax(jnp.abs(ap))]
    return jnp.maximum(vx, vp)


def max_abs_residual(res_xi, res_psi, axis_name: str | None = None):
    """True residual magnitude max(|res_xi|, |res_psi|)_max.

    Used for tolerance-based early termination: the reference-quirk
    diagnostic (signed_max_abs) can report ~0 when the two blocks'
    signed champions cancel, so terminating on it would exit on an
    unconverged solve.  The signed trace stays reference-faithful;
    the stopping rule uses this magnitude.
    """
    m = jnp.maximum(jnp.max(jnp.abs(res_xi)), jnp.max(jnp.abs(res_psi)))
    if axis_name is not None:
        m = lax.pmax(m, axis_name)
    return m
