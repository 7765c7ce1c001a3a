"""Offline tuning: dual preconditioner + APG step size.

The reference consumes a MATLAB-computed diagonal dual preconditioner
(``matDiagPrecnd``, src/SmpcConfiguration.cu:79-83) and a hand-picked
``stepSize``; the repo ships no generator for either (SURVEY §2 #14 —
the MATLAB preprocessing is out-of-band).  For synthetic/benchmark
problems we compute both on-device:

* diagonal (Jacobi) preconditioning of the dual Hessian
  M = H Q^{-1} H': per-stage scale 1/sqrt(diag M), estimated with
  Hutchinson probes through the Hessian oracle;
* step size 1/L with L = ||P M P|| from power iteration, the standard
  dual-APG (GPAD) step rule.

Both reuse the solve-step linear map, so the tuning runs at the same
speed as a few solver iterations.
"""

from __future__ import annotations

import numpy as np

from rapidnet_jax.solver import quasi_newton as qn


def _oracle_prim(fa, xi, psi, prefix_stages):
    h = qn.oracle(fa, xi, psi, prefix_stages=prefix_stages)
    # the oracle map is -M (M PSD); flip sign to get M * input
    return -np.asarray(h["prim_xi"]), -np.asarray(h["prim_psi"])


def estimate_dual_hessian_diag(engine, probes: int = 16, seed: int = 0):
    """Per-stage mean of diag(M) split as (xi 2nx | psi nu) parts.

    Probes are Rademacher vectors constant across each node's duplicated
    fan-layout slots (generated in node layout, then gathered).
    """
    from rapidnet_jax.solver.controller import _factor_arrays
    fa = _factor_arrays(engine)
    tree = engine.tree
    prefix_stages = engine.factor_step().prefix_stages
    nx, nu = engine.network.nx, engine.network.nu
    rng = np.random.default_rng(seed)
    n_nodes = tree.n_nodes

    acc_xi = np.zeros((tree.N, tree.ns, 2 * nx), np.float64)
    acc_psi = np.zeros((tree.N, tree.ns, nu), np.float64)
    for _ in range(probes):
        z_xi = rng.choice([-1.0, 1.0],
                          (n_nodes, 2 * nx)).astype(np.float32)
        z_psi = rng.choice([-1.0, 1.0], (n_nodes, nu)).astype(np.float32)
        zf_xi = tree.gather_to_fan(z_xi)
        zf_psi = tree.gather_to_fan(z_psi)
        m_xi, m_psi = _oracle_prim(fa, zf_xi, zf_psi, prefix_stages)
        acc_xi += zf_xi * m_xi
        acc_psi += zf_psi * m_psi
    acc_xi /= probes
    acc_psi /= probes

    # per-stage average over representative slots
    rep = tree.rep[..., None]
    counts = tree.rep.sum(axis=1)[:, None]
    diag_xi = (rep * acc_xi).sum(axis=1) / counts          # (N, 2nx)
    diag_psi = (rep * acc_psi).sum(axis=1) / counts        # (N, nu)
    return diag_xi, diag_psi


def compute_preconditioner(engine, probes: int = 32, seed: int = 0,
                           rel_floor: float = 1e-2) -> np.ndarray:
    """(N, nu + 2nx) diagonal preconditioner in the reference layout
    [u-part | x-box-part | x-safety-part] (src/SmpcConfiguration.cuh:35).

    Hutchinson diagonal estimates are noisy (they can even go negative
    for small probe counts); entries are floored at ``rel_floor`` times
    the global maximum so noise-dominated rows are never amplified into
    dominating the preconditioned spectrum.
    """
    diag_xi, diag_psi = estimate_dual_hessian_diag(engine, probes, seed)
    nx = engine.network.nx
    dmax = max(float(np.abs(diag_xi).max()), float(np.abs(diag_psi).max()),
               1e-30)
    floor = rel_floor * dmax

    def scale(d):
        return 1.0 / np.sqrt(np.maximum(d, floor))

    prc = np.concatenate(
        [scale(diag_psi), scale(diag_xi[:, :nx]), scale(diag_xi[:, nx:])],
        axis=1)
    return prc.astype(np.float32)


def estimate_dual_lipschitz(engine, iters: int = 30, seed: int = 0
                            ) -> float:
    """||M|| by power iteration through the (preconditioned) oracle."""
    from rapidnet_jax.solver.controller import _factor_arrays
    fa = _factor_arrays(engine)
    tree = engine.tree
    prefix_stages = engine.factor_step().prefix_stages
    nx, nu = engine.network.nx, engine.network.nu
    rng = np.random.default_rng(seed)
    v_xi = tree.gather_to_fan(
        rng.standard_normal((tree.n_nodes, 2 * nx)).astype(np.float32))
    v_psi = tree.gather_to_fan(
        rng.standard_normal((tree.n_nodes, nu)).astype(np.float32))
    rep = tree.rep[..., None]
    nrm = 1.0
    for _ in range(iters):
        m_xi, m_psi = _oracle_prim(fa, v_xi, v_psi, prefix_stages)
        nrm = float(np.sqrt((rep * m_xi * m_xi).sum() +
                            (rep * m_psi * m_psi).sum()))
        if nrm < 1e-30:
            return 1.0
        v_xi, v_psi = m_xi / nrm, m_psi / nrm
    return nrm


def auto_tune(network, tree, config, *, probes: int = 16,
              power_iters: int = 30, safety: float = 0.999,
              seed: int = 0):
    """Return a new (config, engine) with computed preconditioner + step.

    Replaces the reference's out-of-band MATLAB preprocessing for
    problems without a hand-provided matDiagPrecnd/stepSize.
    """
    import copy

    from rapidnet_jax.engine.engine import Engine

    cfg = copy.deepcopy(config)
    base_engine = Engine(network, tree, cfg)
    cfg.diag_precnd = compute_preconditioner(base_engine, probes, seed)
    engine = Engine(network, tree, cfg)
    L = estimate_dual_lipschitz(engine, power_iters, seed)
    cfg.step_size = float(safety / L)
    # engines cache nothing mutable from cfg.step_size, so this engine
    # remains valid for the tuned config
    return cfg, engine
