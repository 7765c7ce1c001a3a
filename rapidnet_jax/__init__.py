"""rapidnet_jax — a scenario-tree stochastic MPC engine in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
GPUEngineering/RapidNet (GPU-accelerated SMPC for drinking water networks):

* mass-balance DWN model ``x+ = x + B u + Gd d`` (reference:
  src/DwnNetwork.cu),
* scenario-tree representation with stage sweeps (src/ScenarioTree.cu),
* offline "factor step" Riccati-like recursion (src/Engine.cu:671-774),
* online dual solvers: APG / global-FBE / NAMA (src/SmpcController.cu),
* closed-loop receding-horizon driver with KPIs (src/main.cu).

Design (not a port):

* **Fan layout** ``(N, ns, dim)``: every stage holds exactly ``ns``
  (=num scenarios) slots; a tree node's value is duplicated across the
  scenario slots of its subtree.  The forward tree sweep then needs no
  gathers at all, and only the short branching prefix needs child->parent
  aggregation (done with dense one-hot matmuls).
* All per-node factor matrices (Phi/Psi/Theta/Omega/D/F/G of the
  reference) are diagonal scalings of three shared small matrices, so the
  online solve step is a handful of ``(ns, k) @ (k, m)`` matmuls per
  stage inside ``lax.scan`` — one jitted XLA program per solve.
* float32 compute everywhere (matching the reference's ``real_t``);
  float64 only in the one-off SVD null-space setup.
* Scenario axis sharding via ``jax.sharding``/``shard_map`` for
  multi-chip scale-out (the reference is single-GPU).
"""

__version__ = "0.1.0"

from rapidnet_jax.model.network import DwnNetwork
from rapidnet_jax.model.scenario_tree import ScenarioTree
from rapidnet_jax.model.forecaster import Forecaster
from rapidnet_jax.model.config import SmpcConfig
from rapidnet_jax.engine.engine import Engine
from rapidnet_jax.solver.controller import SmpcController
from rapidnet_jax.solver.batch import BatchedSmpcController

__all__ = [
    "DwnNetwork",
    "ScenarioTree",
    "Forecaster",
    "SmpcConfig",
    "Engine",
    "SmpcController",
    "BatchedSmpcController",
]
