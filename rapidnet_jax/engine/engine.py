"""Offline engine: preconditioning, factor step, disturbance elimination.

JAX counterpart of the reference ``Engine`` (src/Engine.cu).

Key structural observation exploited here (instead of translating the
reference's batched-pointer cuBLAS idiom, src/Engine.cu:80-107): every
per-node factor matrix produced by the reference factor step
(src/Engine.cu:671-774) is a diagonal scaling of one of three *shared*
small matrices:

    Bb      = L' B'                      (nv, nx)
    M1      = inv(L'WL) @ Bb             (nv, nx)
    M2      = inv(L'WL) @ L'             (nv, nu)

with per-node scalars/diagonals derived from the node probability and the
per-stage dual preconditioner:

    Omega[n] = inv(p_n * L'WL)           = invWbar / p_n
    D[n]     = Bb * [d1_n | d2_n]        (nv, 2nx)   d1/d2 incl. sqrt(p_n)
    F[n]     = L'  * g_n                 (nv, nu)
    G[n]     = Bb                        (nv, nx)
    Phi[n]   = (-1/2p_n) * (M1*[d1_n|d2_n])
    Theta[n] = (-1/2p_n) * M1
    Psi[n]   = (-1/2p_n) * (M2*g_n)

so the online solve step needs only (ns, k) @ (k, m) matmuls against the
shared matrices — plain GEMMs with no pointer arrays and no
per-scenario replication (the reference replicates B/L/Lhat/Gd per
scenario purely to enable cublas batching, src/Engine.cu:404-408).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from rapidnet_jax.engine.nullspace import (nullspace_elimination,
                                           validate_nullspace)
from rapidnet_jax.model.config import (ALGORITHM_APG, ALGORITHM_FBE,
                                       ALGORITHM_NAMA, SmpcConfig)
from rapidnet_jax.model.network import DwnNetwork
from rapidnet_jax.model.scenario_tree import ScenarioTree

# float32 pattern of the reference's `memset(devSysXsUpper, 127, ...)`
# (src/Engine.cu:455): bytes 0x7f7f7f7f ~= 3.396e38, effectively +inf.
XS_UPPER = np.frombuffer(np.array([0x7f7f7f7f], dtype=np.uint32).tobytes(),
                         dtype=np.float32)[0]

# Conditioning limit for the reduced Hessian L'WL.  The online
# iteration runs in f32, so kappa within a few orders of 1/eps_f32
# (~8.4e6) already loses every significant digit of v = Omega @ (...).
WBAR_MAX_CONDITION = 1e7


def _guarded_inverse(Wbar: np.ndarray) -> np.ndarray:
    """inv(L'WL) with explicit conditioning diagnostics.

    Reference counterpart: the `info` checks after the batched LU
    inverse (src/Engine.cu:1335-1353), which catch only exact
    singularity.  Here a near-singular reduced Hessian (rank-deficient
    costW on the null space of E, or a degenerate basis L) raises with
    a remediation hint instead of silently producing garbage controls.
    """
    Wbar64 = np.asarray(Wbar, np.float64)
    cond = np.linalg.cond(Wbar64)
    if not np.isfinite(cond) or cond > WBAR_MAX_CONDITION:
        raise ValueError(
            f"reduced Hessian L'WL is near-singular (condition number "
            f"{cond:.3e} > {WBAR_MAX_CONDITION:.0e}); the dual solvers "
            "run in float32 and would produce garbage. Remedies: make "
            "costW positive definite on null(E) (e.g. add a small "
            "ridge costW += eps*I), or check matL for (near-)dependent "
            "columns.")
    inv64 = np.linalg.inv(Wbar64)
    resid = np.abs(Wbar64 @ inv64 - np.eye(Wbar.shape[0])).max()
    if resid > 1e-6 * max(cond, 1.0):
        raise ValueError(
            f"inverse of L'WL failed verification (|Wbar@inv - I|_max "
            f"= {resid:.3e}, condition {cond:.3e}); costW is likely "
            "indefinite on null(E)")
    return inv64.astype(np.float32)


@dataclass
class FactorData:
    """Constant (per problem) solver inputs, fan layout (N, ns, ...)."""
    # shared small matrices (float32)
    L: np.ndarray          # (nu, nv)
    B: np.ndarray          # (nx, nu)
    Bb: np.ndarray         # (nv, nx)  = L' B'
    invWbar: np.ndarray    # (nv, nv)  = inv(L' W L)
    # per-slot diagonals (include sqrt(node prob))
    d1: np.ndarray         # (N, ns, nx)
    d2: np.ndarray         # (N, ns, nx)
    g: np.ndarray          # (N, ns, nu)
    neg_half_over_prob: np.ndarray  # (N, ns, 1)
    prob: np.ndarray       # (N, ns, 1)
    rep: np.ndarray        # (N, ns) 0/1 representative-slot mask
    # preconditioned constraint bounds, fan layout
    xmin: np.ndarray       # (N, ns, nx)
    xmax: np.ndarray       # (N, ns, nx)
    xs: np.ndarray         # (N, ns, nx)
    umin: np.ndarray       # (N, ns, nu)
    umax: np.ndarray       # (N, ns, nu)
    # prefix aggregation: stages (desc order) and stacked C matrices
    prefix_stages: tuple   # static tuple of ints, descending
    prefix_C: dict         # stage -> (ns, ns) float32 (= Bp @ Cp)
    prefix_Cp: dict        # stage -> (Rp, ns) distinct-parent child sums
    prefix_Bp: dict        # stage -> (ns, Rp) parent -> slot broadcast
    final_branch_stage: int


@dataclass
class StepData:
    """Per-control-step solver inputs (from disturbance elimination)."""
    beta: np.ndarray       # (N, ns, nv) fan layout
    uhat: np.ndarray       # (N, ns, nu)
    e: np.ndarray          # (N, ns, nx)
    alpha_price: np.ndarray  # (N, ns, nu) scaled price vector (FBE value)
    x0: np.ndarray         # (nx,)
    prev_u: np.ndarray     # (nu,)
    prev_uhat: np.ndarray  # (nu,)


class Engine:
    """Owns the constant problem data and the offline factor step."""

    def __init__(self, network: DwnNetwork, tree: ScenarioTree,
                 config: SmpcConfig):
        network.validate()
        self.network = network
        self.tree = tree
        self.config = config
        self.price_uncertainty = True
        self.demand_uncertainty = True

        nu, nx, nd, ne = network.nu, network.nx, network.nd, network.ne
        nv = config.nv
        assert nv == nu - ne, f"nv={nv} must equal nu-ne={nu - ne}"

        # --- null-space elimination (reference: src/Engine.cu:466-669) ---
        L_svd, Lhat_svd = nullspace_elimination(network.matE, network.matEd)
        if config.mat_l is not None:
            # prefer the config-provided basis: the dual algorithms are
            # invariant to the null-space basis choice, but fixture parity
            # of per-node factor matrices requires the reference's basis.
            self.L = np.asarray(config.mat_l, np.float32)
            self.Lhat = (np.asarray(config.mat_lhat, np.float32)
                         if config.mat_lhat is not None else Lhat_svd)
        else:
            self.L, self.Lhat = L_svd, Lhat_svd
        validate_nullspace(network.matE, network.matEd, self.L, self.Lhat,
                           atol=1e-3)

        # --- shared factor matrices ---
        W = np.asarray(config.cost_w, np.float32)
        self.Wv = (W @ self.L).astype(np.float32)               # (nu, nv)
        self.Wbar = (self.L.T @ self.Wv).astype(np.float32)     # (nv, nv)
        self.invWbar = _guarded_inverse(self.Wbar)
        self.Bb = (self.L.T @ network.matB.T).astype(np.float32)  # (nv, nx)
        self.M1 = (self.invWbar @ self.Bb).astype(np.float32)
        self.M2 = (self.invWbar @ self.L.T).astype(np.float32)

        # --- per-node preconditioner diagonals (incl sqrt(prob)) ---
        # reference kernels: preconditionSystem / ConstraintX / ConstraintU
        # (src/Utilities.cu:33-58, 360-405)
        prc = np.asarray(config.diag_precnd, np.float32)  # (N, nu+2nx)
        stage = tree.stage
        sqrtp = np.sqrt(tree.prob).astype(np.float32)[:, None]
        self.g_node = sqrtp * prc[stage, :nu]                    # (nodes, nu)
        self.d1_node = sqrtp * prc[stage, nu:nu + nx]            # (nodes, nx)
        self.d2_node = sqrtp * prc[stage, nu + nx:]              # (nodes, nx)

        # preconditioned bounds per node
        self.xmin_node = self.d1_node * network.xmin[None, :]
        self.xmax_node = self.d1_node * network.xmax[None, :]
        self.xs_node = self.d2_node * network.xsafe[None, :]
        self.umin_node = self.g_node * network.umin[None, :]
        self.umax_node = self.g_node * network.umax[None, :]

        self._factor: Optional[FactorData] = None

    # ------------------------------------------------------------------
    def factor_step(self) -> FactorData:
        """Build the constant solver inputs (reference factor step).

        The reference runs a stage-recursive batched-GEMM sweep
        (src/Engine.cu:716-747); with the shared-matrix factorisation the
        result is closed-form, so this is pure layout work.
        """
        if self._factor is not None:
            return self._factor
        tree = self.tree
        gather = tree.gather_to_fan
        prob_fan = gather(self.tree.prob)[..., None].astype(np.float32)
        prefix_stages = tuple(sorted(tree.prefix_agg.keys(), reverse=True))
        self._factor = FactorData(
            L=self.L, B=self.network.matB, Bb=self.Bb, invWbar=self.invWbar,
            d1=gather(self.d1_node), d2=gather(self.d2_node),
            g=gather(self.g_node),
            neg_half_over_prob=(-0.5 / prob_fan).astype(np.float32),
            prob=prob_fan,
            rep=tree.rep,
            xmin=gather(self.xmin_node), xmax=gather(self.xmax_node),
            xs=gather(self.xs_node),
            umin=gather(self.umin_node), umax=gather(self.umax_node),
            prefix_stages=prefix_stages,
            prefix_C={s: tree.prefix_agg[s] for s in prefix_stages},
            prefix_Cp={s: tree.prefix_Cp[s] for s in prefix_stages},
            prefix_Bp={s: tree.prefix_Bp[s] for s in prefix_stages},
            final_branch_stage=tree.final_branch_stage,
        )
        return self._factor

    # ------------------------------------------------------------------
    # node-layout factor tensors, for parity tests against the
    # reference's engineTest.json golden values (src/test/Testing.cu:340-477)
    def factor_tensors_node_layout(self) -> dict[str, np.ndarray]:
        p = self.tree.prob.astype(np.float32)[:, None, None]
        scale = -0.5 / p
        d1 = self.d1_node[:, None, :]     # (nodes, 1, nx)
        d2 = self.d2_node[:, None, :]
        g = self.g_node[:, None, :]
        Bb = self.Bb[None]
        M1 = self.M1[None]
        M2 = self.M2[None]
        D = np.concatenate([Bb * d1, Bb * d2], axis=2)
        Phi = scale * np.concatenate([M1 * d1, M1 * d2], axis=2)
        return {
            "omega": self.invWbar[None] / p,
            "d": D,
            "f": self.L.T[None] * g,
            "g": np.broadcast_to(self.Bb, (self.tree.ns,) + self.Bb.shape),
            "phi": Phi,
            "theta": scale * np.broadcast_to(M1, (self.tree.n_nodes,) +
                                             self.M1.shape),
            "psi": scale * (M2 * g),
            "Bbar": np.broadcast_to(self.Bb, (self.tree.ns,) + self.Bb.shape),
        }

    # ------------------------------------------------------------------
    def eliminate_input_disturbance_coupling(
            self, nominal_demand: np.ndarray, nominal_prices: np.ndarray,
            prev_uhat: np.ndarray) -> dict[str, np.ndarray]:
        """Node-layout disturbance elimination.

        Reference: Engine::eliminateInputDistubanceCoupling
        (src/Engine.cu:1147-1298).  Produces, per node:
          demand  d_n   = errDemand_n + dHat[stage]
          e_n           = Gd d_n
          uhat_n        = Lhat d_n
          alpha_n       = weightEco * (errPrice_n + alphaHat[stage] + alpha1)
          beta_n        = 2 (W L)' zeta_n + p_n L' alpha_n
        with zeta_n = p_n duhat_n - sum_children p_c duhat_c and
        duhat_n = uhat_n - uhat_anc(n) (root: - prev_uhat).
        """
        tree, net = self.tree, self.network
        stage = tree.stage
        dhat = np.asarray(nominal_demand, np.float32)        # (N, nd)
        ahat = np.asarray(nominal_prices, np.float32)        # (N, nu)

        err_d = tree.err_demand if self.demand_uncertainty else 0.0
        demand = err_d + dhat[stage]                          # (nodes, nd)
        e = demand @ net.matGd.T                              # (nodes, nx)
        uhat = demand @ self.Lhat.T                           # (nodes, nu)

        err_p = tree.err_price if self.price_uncertainty else 0.0
        alpha = (err_p + ahat[stage] + net.alpha1[None, :])
        alpha = (self.config.weight_economical * alpha).astype(np.float32)
        alpha_bar = alpha @ self.L                            # (nodes, nv)

        anc = tree.ancestor
        duhat = np.empty_like(uhat)
        duhat[0] = uhat[0] - prev_uhat
        duhat[1:] = uhat[1:] - uhat[anc[1:]]

        p = tree.prob[:, None]
        zeta = p * duhat
        # subtract children contributions (reference calculateZeta,
        # src/Utilities.cu:100-131)
        np.subtract.at(zeta, anc[1:], p[1:] * duhat[1:])

        beta = 2.0 * (zeta @ self.Wv) + p * alpha_bar         # (nodes, nv)
        return {"demand": demand, "e": e, "uhat": uhat,
                "alpha": alpha, "beta": beta.astype(np.float32)}

    # ------------------------------------------------------------------
    def prepare_step_shared(self, nominal_demand: np.ndarray,
                            nominal_prices: np.ndarray,
                            x0s: np.ndarray, prev_us: np.ndarray,
                            prev_demands: np.ndarray
                            ) -> tuple[dict, dict]:
        """Shared-base + per-instance form of :meth:`prepare_step_batch`.

        Returns ``(base, inst)``: ``base`` holds the (unbatched) fan
        arrays shared by every instance (beta computed with
        prev_uhat = 0); ``inst`` holds the per-instance vectors —
        x0, prev_u, prev_uhat and the root beta correction
        ``delta_beta0 = -2 p0 (prev_uhat @ Wv)``.  The batched step is
        assembled ON DEVICE by the shared-batch solvers, so the
        host->device staging per control step is O(tree) + O(B nu)
        instead of O(B tree) — the difference between ~25 MB and ~1 MB
        per step at Barcelona scale with B=32.
        """
        x0s = np.asarray(x0s, np.float32)
        prev_us = np.asarray(prev_us, np.float32)
        prev_demands = np.asarray(prev_demands, np.float32)
        prev_uhats = (prev_demands @ self.Lhat.T).astype(np.float32)
        node = self.eliminate_input_disturbance_coupling(
            nominal_demand, nominal_prices,
            np.zeros(self.network.nu, np.float32))
        gather = self.tree.gather_to_fan
        p0 = float(self.tree.prob[0])
        base = {
            "beta": gather(node["beta"]),
            "uhat": gather(node["uhat"]),
            "e": gather(node["e"]),
            "alpha_price": gather(node["alpha"]),
        }
        inst = {
            "x0": x0s,
            "prev_u": prev_us,
            "prev_uhat": prev_uhats,
            "delta_beta0": (-2.0 * p0 *
                            (prev_uhats @ self.Wv)).astype(np.float32),
        }
        return base, inst

    # ------------------------------------------------------------------
    def prepare_step_batch(self, nominal_demand: np.ndarray,
                           nominal_prices: np.ndarray,
                           x0s: np.ndarray, prev_us: np.ndarray,
                           prev_demands: np.ndarray) -> dict:
        """Batched per-step inputs for B instances sharing one forecast.

        The disturbance elimination depends on the instance state only
        through prev_uhat, which enters linearly and only at the root
        node: beta_0(b) = beta_0(base) - 2 p_0 (prev_uhat_b @ Wv).  So
        the (expensive) node-level elimination runs ONCE and each
        instance gets an O(nu nv) root correction — ~30x cheaper on the
        host than B independent prepare_step calls at Barcelona scale.

        Returns the batched step dict (leading batch axis on every
        leaf) consumed by the batched/2-D-mesh solvers.
        """
        base, inst = self.prepare_step_shared(
            nominal_demand, nominal_prices, x0s, prev_us, prev_demands)
        B = inst["x0"].shape[0]
        beta = np.broadcast_to(
            base["beta"], (B,) + base["beta"].shape
        ).astype(np.float32).copy()
        beta[:, 0] += inst["delta_beta0"][:, None, :]

        def rep(a):
            return np.broadcast_to(a, (B,) + a.shape)

        return {
            "beta": beta,
            "uhat": rep(base["uhat"]),
            "e": rep(base["e"]),
            "alpha_price": rep(base["alpha_price"]),
            "x0": inst["x0"],
            "prev_u": inst["prev_u"],
            "prev_uhat": inst["prev_uhat"],
        }

    # ------------------------------------------------------------------
    def prepare_step(self, nominal_demand: np.ndarray,
                     nominal_prices: np.ndarray,
                     current_x: np.ndarray, prev_u: np.ndarray,
                     prev_demand: np.ndarray) -> StepData:
        """Fan-layout per-step solver inputs.

        Combines the reference's updateStateControl
        (src/Engine.cu:1300-1316) and eliminateInputDistubanceCoupling.
        """
        prev_uhat = (np.asarray(prev_demand, np.float32) @
                     self.Lhat.T).astype(np.float32)
        node = self.eliminate_input_disturbance_coupling(
            nominal_demand, nominal_prices, prev_uhat)
        gather = self.tree.gather_to_fan
        return StepData(
            beta=gather(node["beta"]),
            uhat=gather(node["uhat"]),
            e=gather(node["e"]),
            alpha_price=gather(node["alpha"]),
            x0=np.asarray(current_x, np.float32),
            prev_u=np.asarray(prev_u, np.float32),
            prev_uhat=prev_uhat,
        )
