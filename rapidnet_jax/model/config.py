"""SMPC controller configuration.

Reference counterpart: ``SmpcConfiguration`` (src/SmpcConfiguration.cu:
28-126; JSON keys at src/SmpcConfiguration.cuh:24-47).  The config JSON
doubles as the closed-loop state store in the reference (currentX /
prevU / prevDemand read-back, src/SmpcConfiguration.cu:240-293 — note we
deliberately do NOT replicate its setPreviousDemand-writes-to-prevU
copy-paste bug at src/SmpcConfiguration.cu:290).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from rapidnet_jax.io import jsonio

ALGORITHM_APG = "proximalAlgorithm"
ALGORITHM_FBE = "globalFbeAlgorithm"
ALGORITHM_NAMA = "namaAlgorithm"


@dataclass
class SmpcConfig:
    nx: int
    nu: int
    nd: int
    nv: int
    N: int
    mat_l: np.ndarray | None        # (nu, nv) null-space basis of E
    mat_lhat: np.ndarray | None     # (nu, nd) particular solution -pinv(E)Ed
    cost_w: np.ndarray              # (nu, nu) smoothness weight
    penalty_state: float
    penalty_safety: float
    diag_precnd: np.ndarray         # (N, nu + 2nx) dual diagonal preconditioner
    current_x: np.ndarray           # (nx,)
    prev_u: np.ndarray              # (nu,)
    prev_demand: np.ndarray         # (nd,)
    step_size: float
    max_iterations: int
    algorithm: str = ALGORITHM_APG
    lbfgs_buffer_size: int = 5
    weight_economical: float = 1.0
    path_to_network: str = ""
    path_to_scenario_tree: str = ""
    path_to_forecaster: str = ""
    path_to_config: str = ""

    @classmethod
    def from_json(cls, path) -> "SmpcConfig":
        doc = jsonio.load_json(path)
        nx = jsonio.scalar(doc, "nx")
        nu = jsonio.scalar(doc, "nu")
        nd = jsonio.scalar(doc, "nd")
        nv = jsonio.scalar(doc, "nv")
        N = jsonio.scalar(doc, "N")
        base = os.path.dirname(os.path.abspath(path))

        def respath(key):
            p = doc.get(key, "")
            if not p:
                return ""
            # reference configs use paths relative to the build dir
            # (e.g. "../test/testDataFiles/network.json"); resolve
            # against the config file location and common anchors.
            cands = [
                p,
                os.path.join(base, p),
                os.path.join(base, os.path.basename(p)),
                os.path.normpath(os.path.join(base, "..", p)),
            ]
            for c in cands:
                if os.path.exists(c):
                    return c
            return p

        return cls(
            nx=nx, nu=nu, nd=nd, nv=nv, N=N,
            mat_l=jsonio.matrix_colmajor(doc, "matL", nu, nv)
            if "matL" in doc else None,
            mat_lhat=jsonio.matrix_colmajor(doc, "matLhat", nu, nd)
            if "matLhat" in doc else None,
            cost_w=jsonio.matrix_colmajor(doc, "costW", nu, nu),
            penalty_state=jsonio.scalar(doc, "penaltyStateX", float),
            penalty_safety=jsonio.scalar(doc, "penaltySafetyX", float),
            diag_precnd=jsonio.vector(
                doc, "matDiagPrecnd").reshape(N, nu + 2 * nx),
            current_x=jsonio.vector(doc, "currentX"),
            prev_u=jsonio.vector(doc, "prevU"),
            prev_demand=jsonio.vector(doc, "prevDemand"),
            step_size=jsonio.scalar(doc, "stepSize", float),
            max_iterations=jsonio.scalar(doc, "maxIterations"),
            algorithm=doc.get("algorithmName", ALGORITHM_APG),
            lbfgs_buffer_size=jsonio.scalar(doc, "lbfgsBufferSize")
            if "lbfgsBufferSize" in doc else 5,
            path_to_network=respath("pathToNetwork"),
            path_to_scenario_tree=respath("pathToScenarioTree"),
            path_to_forecaster=respath("pathToForecaster"),
            path_to_config=str(path),
        )

    # closed-loop state setters (reference parity:
    # src/SmpcConfiguration.cu:215-238)
    def set_current_state(self, x: np.ndarray) -> None:
        self.current_x = np.asarray(x, np.float32).copy()

    def set_previous_control(self, u: np.ndarray) -> None:
        self.prev_u = np.asarray(u, np.float32).copy()

    def set_previous_demand(self, d: np.ndarray) -> None:
        self.prev_demand = np.asarray(d, np.float32).copy()


def default_preconditioner(nx: int, nu: int, N: int) -> np.ndarray:
    """Identity dual preconditioner (N, nu+2nx) when none is provided."""
    return np.ones((N, nu + 2 * nx), np.float32)


def synthetic_config(network, tree, *, step_size=1e-4, max_iterations=500,
                     algorithm=ALGORITHM_APG, seed=0) -> SmpcConfig:
    """Build a config for a synthetic problem (benchmark ladder)."""
    rng = np.random.default_rng(seed)
    nx, nu, nd, ne = network.nx, network.nu, network.nd, network.ne
    nv = nu - ne
    x0 = (0.3 * network.xmax).astype(np.float32)
    return SmpcConfig(
        nx=nx, nu=nu, nd=nd, nv=nv, N=tree.N,
        mat_l=None, mat_lhat=None,
        cost_w=(2.0 * np.eye(nu, dtype=np.float32)),
        penalty_state=1e6, penalty_safety=1e4,
        diag_precnd=default_preconditioner(nx, nu, tree.N),
        current_x=x0,
        prev_u=np.zeros(nu, np.float32),
        prev_demand=rng.uniform(0.05, 0.3, nd).astype(np.float32),
        step_size=step_size, max_iterations=max_iterations,
        algorithm=algorithm,
    )
