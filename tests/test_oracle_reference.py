"""The dual-gradient oracle against a plain NumPy reference.

``reference_oracle`` is an independent float64 implementation of one
oracle sweep (src/SmpcController.cu:563-755) in the reference's NODE
layout: a backward pass over nodes with an explicit child sum (the
prefix aggregation of the fan layout), then a forward pass from each
node's ancestor.  ``solve_step`` runs the same sweep in the fan layout,
through either the stage scan or the batched-cumsum path
(``SCAN_MIN_NS``); its fan outputs must equal the reference gathered to
the fan layout, duplicated slots included.
"""

import jax
import numpy as np
import pytest

from rapidnet_jax.engine.engine import Engine
from rapidnet_jax.model.config import synthetic_config
from rapidnet_jax.model.forecaster import synthetic_forecaster
from rapidnet_jax.model.network import synthetic_network
from rapidnet_jax.model.scenario_tree import generate_tree
from rapidnet_jax.solver import quasi_newton
from rapidnet_jax.solver import solve_step as ss
from rapidnet_jax.solver.controller import _factor_arrays, _step_arrays

# (N, branching): deterministic chain, a single split, two splits, a
# deep prefix, and a tree that branches up to its last stage (no tail).
TREES = [(4, [1]), (5, [3]), (6, [2, 2]), (10, [4, 2, 2]), (3, [2, 3])]


def reference_oracle(tree, fa, step, w_xi, w_psi):
    """Node-layout float64 oracle sweep; returns node arrays."""
    f64 = np.float64

    def node(a):
        return tree.scatter_from_fan(np.asarray(a, f64))

    d1, d2, g, nhp = (node(fa[k]) for k in ("d1", "d2", "g", "nhp"))
    beta, uhat, e = (node(step[k]) for k in ("beta", "uhat", "e"))
    xi, psi = node(w_xi), node(w_psi)
    Bb, L, B, invWbar = (np.asarray(fa[k], f64)
                         for k in ("Bb", "L", "B", "invWbar"))
    nx, nu, nv = Bb.shape[1], L.shape[0], invWbar.shape[0]
    n = tree.n_nodes
    order = np.argsort(tree.stage, kind="stable")   # parents first

    t = np.zeros((n, nx))
    inner = np.zeros((n, nv))
    v = np.zeros((n, nv))
    for k in order[::-1]:
        kids = tree.children_of[k]
        q = t[kids].sum(axis=0)
        r = inner[kids].sum(axis=0)
        t[k] = d1[k] * xi[k, :nx] + d2[k] * xi[k, nx:] + q
        inner[k] = beta[k] + r + t[k] @ Bb.T + (g[k] * psi[k]) @ L
        v[k] = nhp[k] * (inner[k] @ invWbar.T)

    du = np.zeros((n, nu))
    x = np.zeros((n, nx))
    u = np.zeros((n, nu))
    du_root = np.asarray(step["prev_u"], f64) - np.asarray(
        step["prev_uhat"], f64)
    for k in order:
        a = tree.ancestor[k]
        du[k] = (du_root if a < 0 else du[a]) + v[k] @ L.T
        u[k] = uhat[k] + du[k]
        x_prev = np.asarray(step["x0"], f64) if a < 0 else x[a]
        x[k] = x_prev + e[k] + u[k] @ B.T
    return {"v": v, "x": x, "u": u,
            "prim_xi": np.concatenate([d1 * x, d2 * x], axis=-1),
            "prim_psi": g * u}


def _problem(N, branching):
    nx, nu, nd, ne = 4, 7, 3, 2
    net = synthetic_network(nx=nx, nu=nu, nd=nd, ne=ne, seed=5)
    tree = generate_tree(N=N, branching=branching, nd=nd, nu=nu, seed=5)
    fc = synthetic_forecaster(N=N, nd=nd, nu=nu, sim_horizon=2, seed=5)
    cfg = synthetic_config(net, tree, step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = _factor_arrays(eng)
    step = _step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, cfg.current_x, cfg.prev_u,
        cfg.prev_demand))
    rng = np.random.default_rng(N)
    w_xi = tree.gather_to_fan(
        rng.standard_normal((tree.n_nodes, 2 * nx)).astype(np.float32))
    w_psi = tree.gather_to_fan(
        rng.standard_normal((tree.n_nodes, nu)).astype(np.float32))
    return tree, eng, fa, step, w_xi, w_psi


@pytest.mark.parametrize("affine", [True, False],
                         ids=["solve_step", "hessian_oracle"])
@pytest.mark.parametrize("path", ["cumsum", "scan"])
@pytest.mark.parametrize("N,branching", TREES,
                         ids=[f"N{n}_{'x'.join(map(str, b))}"
                              for n, b in TREES])
def test_oracle_matches_numpy_reference(N, branching, path, affine,
                                        monkeypatch):
    tree, eng, fa, step, w_xi, w_psi = _problem(N, branching)
    monkeypatch.setattr(ss, "SCAN_MIN_NS", 1 if path == "scan" else 1 << 30)
    prefix = eng.factor_step().prefix_stages
    if affine:
        got = jax.jit(lambda fa, s, a, b: ss.solve_step(
            fa, a, b, s["beta"], s["uhat"], s["e"], s["x0"], s["prev_u"],
            s["prev_uhat"], prefix_stages=prefix))(fa, step, w_xi, w_psi)
    else:
        got = jax.jit(lambda fa, a, b: quasi_newton.oracle(
            fa, a, b, prefix_stages=prefix))(fa, w_xi, w_psi)
        step = {k: np.zeros_like(np.asarray(v)) for k, v in step.items()}
    ref = reference_oracle(tree, fa, step, w_xi, w_psi)
    for k in ("v", "x", "u", "prim_xi", "prim_psi"):
        want = tree.gather_to_fan(ref[k])
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(np.asarray(got[k]), want, rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
