"""Batched receding-horizon closed-loop runs (BASELINE config #5).

Runs B independent closed-loop SMPC instances in lockstep over one
network/tree: per time step, every instance's forecast/disturbance
elimination happens host-side, the B solves run as ONE batched XLA
program (``apg.make_apg_batch`` / ``quasi_newton.make_solver_batch``),
and the built-in simulator advances each instance.

The reference has no batched story (one GPU, one problem instance per
process — src/main.cu:34-68).  Batching is the main throughput lever:
one instance's per-stage matrices are far too small to fill a device,
and a batch amortises the fixed per-program launch overhead.

Typical uses: Monte-Carlo evaluation of a controller over initial
conditions / demand realisations, controller tuning sweeps, and
throughput benchmarking.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from rapidnet_jax.engine.engine import XS_UPPER, Engine
from rapidnet_jax.model.config import ALGORITHM_APG, SmpcConfig
from rapidnet_jax.model.forecaster import Forecaster
from rapidnet_jax.model.network import DwnNetwork
from rapidnet_jax.model.scenario_tree import ScenarioTree
from rapidnet_jax.solver import apg as apg_mod
from rapidnet_jax.solver.controller import _step_arrays, _factor_arrays
from rapidnet_jax.utils.platform import device_platform


def _stack(dicts: Sequence[dict]) -> dict:
    return {k: jnp.stack([d[k] for d in dicts]) for k in dicts[0]}


class BatchedSmpcController:
    """B closed-loop instances, one batched solve per time step.

    Instances share the network, scenario tree, factor step and
    iteration budget; they differ in initial state (``x0_batch``) and —
    optionally — in demand realisation (pass one forecaster per
    instance in ``forecasters``).  KPIs are tracked per instance.
    """

    def __init__(self, config: SmpcConfig, network: DwnNetwork,
                 tree: ScenarioTree,
                 forecasters: Forecaster | Sequence[Forecaster],
                 x0_batch: np.ndarray,
                 warm_start: bool = False,
                 tolerance: Optional[float] = None,
                 mesh=None):
        """mesh: optional 2-D ('batch', 'scen') Mesh
        (parallel.make_mesh_2d) — instances shard the batch axis and
        each instance's scenario tree shards the scenario axis."""
        self.tolerance = tolerance
        self.mesh = mesh
        self.config = config
        self.network = network
        self.tree = tree
        x0_batch = np.asarray(x0_batch, np.float32)
        if x0_batch.ndim != 2:
            raise ValueError("x0_batch must be (B, nx)")
        self.batch = x0_batch.shape[0]
        if isinstance(forecasters, Forecaster):
            forecasters = [forecasters] * self.batch
        if len(forecasters) != self.batch:
            raise ValueError("need one forecaster (shared) or B")
        self.forecasters = list(forecasters)
        # one shared forecaster -> one elimination per time step with a
        # per-instance root correction, and the batch is assembled on
        # device from the shared base (Engine.prepare_step_shared)
        self._shared_forecast = all(f is self.forecasters[0]
                                    for f in self.forecasters)
        self.engine = Engine(network, tree, config)
        self.warm_start = warm_start
        self._y_carry = None
        self._solver = None
        self._fa = None
        self.solve_times_ms: list[float] = []

        # per-instance closed-loop state
        self.current_x = x0_batch.copy()
        self.prev_u = np.tile(np.asarray(config.prev_u, np.float32),
                              (self.batch, 1))
        self.prev_demand = np.tile(
            np.asarray(config.prev_demand, np.float32), (self.batch, 1))
        self._last_control: Optional[np.ndarray] = None

        # per-instance KPI accumulators
        self.economic_kpi_acc = np.zeros(self.batch)
        self.smooth_kpi_acc = np.zeros(self.batch)
        self.safe_kpi_acc = np.zeros(self.batch)
        self.network_kpi_acc = np.zeros(self.batch)

    # ------------------------------------------------------------------
    def initialise(self) -> None:
        device_platform(None if self.mesh is None
                        else self.mesh.devices.flat[0])
        self._fa = _factor_arrays(self.engine)
        cfg = self.config
        is_apg = cfg.algorithm == ALGORITHM_APG
        kw = dict(inv_step=float(1.0 / cfg.step_size),
                  step_size=float(cfg.step_size),
                  penalty_state=float(cfg.penalty_state),
                  penalty_safety=float(cfg.penalty_safety),
                  xs_upper=float(XS_UPPER),
                  max_iterations=int(cfg.max_iterations))
        kw_tol = dict(kw, tolerance=self.tolerance)
        qn_kw = dict(kw_tol, algorithm=cfg.algorithm,
                     lbfgs_buffer_size=int(cfg.lbfgs_buffer_size))
        prefix_stages = self.engine.factor_step().prefix_stages
        if self.mesh is not None:
            from rapidnet_jax.parallel import (make_sharded_apg_batch,
                                               make_sharded_batch_shared,
                                               make_sharded_qn_batch,
                                               shard_factor_arrays)
            fc = self.forecasters[0]
            fc.predict_demand(0)
            fc.predict_prices(0)
            if self._shared_forecast:
                # device-side batch assembly: the base fan arrays ship
                # once per step (O(tree)), not O(B x tree)
                base_t, inst_t = self.engine.prepare_step_shared(
                    fc.nominal_demand, fc.nominal_prices, self.current_x,
                    self.prev_u, self.prev_demand)
                self._solver = make_sharded_batch_shared(
                    self.mesh, self._fa, base_t, inst_t,
                    algorithm=cfg.algorithm,
                    lbfgs_buffer_size=int(cfg.lbfgs_buffer_size),
                    prefix_stages=prefix_stages, **kw_tol)
            else:
                step_t = _step_arrays(self.engine.prepare_step(
                    fc.nominal_demand, fc.nominal_prices,
                    self.current_x[0], self.prev_u[0],
                    self.prev_demand[0]))
                if is_apg:
                    self._solver = make_sharded_apg_batch(
                        self.mesh, self._fa, step_t,
                        prefix_stages=prefix_stages, **kw_tol)
                else:
                    self._solver = make_sharded_qn_batch(
                        self.mesh, self._fa, step_t,
                        prefix_stages=prefix_stages, **qn_kw)
            self._fa = shard_factor_arrays(self._fa, self.mesh)
            return
        if is_apg:
            make_batch = apg_mod.make_apg_batch
            make_batch_shared = apg_mod.make_apg_batch_shared
            qn_kw = kw_tol
        else:
            from rapidnet_jax.solver import quasi_newton
            make_batch = quasi_newton.make_solver_batch
            make_batch_shared = quasi_newton.make_solver_batch_shared
        if self._shared_forecast:
            run = make_batch_shared(prefix_stages=prefix_stages, **qn_kw)
        else:
            run = make_batch(prefix_stages=prefix_stages, **qn_kw)
        self._solver = jax.jit(run)

    # ------------------------------------------------------------------
    def control_action(self, sim_time: int) -> np.ndarray:
        """One batched solve; returns the (B, nu) stage-0 controls."""
        if self._solver is None:
            self.initialise()
        shared_args = None
        if self._shared_forecast:
            fc = self.forecasters[0]
            if not (fc.predict_demand(sim_time) and
                    fc.predict_prices(sim_time)):
                raise IndexError(f"forecaster exhausted at t={sim_time}")
            # shared-base form: assemble the batch ON DEVICE (both the
            # single-device and the 2-D mesh paths)
            base, inst = self.engine.prepare_step_shared(
                fc.nominal_demand, fc.nominal_prices,
                self.current_x, self.prev_u, self.prev_demand)
            if self.mesh is None:
                shared_args = (
                    {k: jnp.asarray(v) for k, v in base.items()},
                    {k: jnp.asarray(v) for k, v in inst.items()})
            else:
                from rapidnet_jax.parallel import shard_shared_step
                shared_args = shard_shared_step(base, inst, self.mesh)
        else:
            steps = []
            for b in range(self.batch):
                fc = self.forecasters[b]
                if not (fc.predict_demand(sim_time) and
                        fc.predict_prices(sim_time)):
                    raise IndexError(
                        f"forecaster exhausted at t={sim_time}")
                steps.append(_step_arrays(self.engine.prepare_step(
                    fc.nominal_demand, fc.nominal_prices,
                    self.current_x[b], self.prev_u[b],
                    self.prev_demand[b])))
            batched = _stack(steps)
        t0 = time.perf_counter()
        y0 = self._y_carry if self.warm_start else None
        if self.mesh is not None:
            from rapidnet_jax.parallel import (shard_dual_arrays,
                                               shard_step_arrays_batch)
            if self._y_carry is None:
                # fixed shard_map signature: cold start = sharded zeros
                N, ns = self._fa["d1"].shape[:2]
                nx = self._fa["d1"].shape[-1]
                nu = self._fa["g"].shape[-1]
                B = self.batch
                self._y_carry = shard_dual_arrays(
                    {"xi": np.zeros((B, N, ns, 2 * nx), np.float32),
                     "psi": np.zeros((B, N, ns, nu), np.float32)},
                    self.mesh, batched=True)
            if shared_args is not None:
                base, inst = shared_args
                out = self._solver(self._fa, base, inst, self._y_carry)
            else:
                out = self._solver(
                    self._fa, shard_step_arrays_batch(batched, self.mesh),
                    self._y_carry)
        elif shared_args is not None:
            base, inst = shared_args
            out = self._solver(self._fa, base, inst, y0)
        else:
            out = self._solver(self._fa, batched, y0)
        control = np.asarray(jax.block_until_ready(out["control"]))
        self.solve_times_ms.append((time.perf_counter() - t0) * 1e3)
        if self.warm_start:
            self._y_carry = out["y"]
        self._last = out
        self._last_control = control
        return control

    # ------------------------------------------------------------------
    def move_forward_in_time(self) -> np.ndarray:
        """Built-in simulator for every instance: x+ = x + B u + Gd d."""
        u = self._last_control
        if u is None:
            raise RuntimeError("call control_action first")
        d = np.stack([fc.nominal_demand[0] for fc in self.forecasters])
        x = (self.current_x + u @ self.network.matB.T +
             d @ self.network.matGd.T).astype(np.float32)
        self._update_kpi(x, u)
        self.current_x = x
        self.prev_u = u.copy()
        self.prev_demand = d
        return x

    def _update_kpi(self, state, control) -> None:
        net, cfg = self.network, self.config
        prices = np.stack([fc.nominal_prices[0]
                           for fc in self.forecasters])
        self.economic_kpi_acc += np.sum(
            cfg.weight_economical * (net.alpha1 + prices) *
            np.abs(control), axis=1)
        du = self.prev_u - control
        self.smooth_kpi_acc += np.sum(du * du, axis=1)
        level = np.minimum(state - net.xsafe, 0.0)
        self.safe_kpi_acc += np.abs(level).sum(axis=1)
        self.network_kpi_acc += np.abs(state).sum(axis=1)

    # per-instance KPI getters (same normalisation as SmpcController)
    def economic_kpi(self, sim_time: int) -> np.ndarray:
        return self.economic_kpi_acc / 3600.0 / max(sim_time, 1)

    def smooth_kpi(self, sim_time: int) -> np.ndarray:
        return self.smooth_kpi_acc / 3600.0 / max(sim_time, 1)

    def safety_kpi(self, sim_time: int) -> np.ndarray:
        return self.safe_kpi_acc.copy()

    def network_kpi(self, sim_time: int) -> np.ndarray:
        safe_norm = float(np.sum(self.network.xsafe))
        out = np.zeros(self.batch)
        nz = self.network_kpi_acc != 0
        out[nz] = (100.0 * max(sim_time, 1) * safe_norm /
                   self.network_kpi_acc[nz])
        return out

    # ------------------------------------------------------------------
    def closed_loop(self, steps: int) -> dict:
        """Run all B instances for ``steps`` time instances; returns the
        per-step (B, nu) controls, solve times and per-instance KPIs."""
        controls = []
        for t in range(steps):
            controls.append(self.control_action(t))
            self.move_forward_in_time()
        return {
            "controls": np.stack(controls),      # (T, B, nu)
            "solve_times_ms": list(self.solve_times_ms),
            "economicKpi": self.economic_kpi(steps),
            "smoothKpi": self.smooth_kpi(steps),
            "safetyKpi": self.safety_kpi(steps),
            "networkKpi": self.network_kpi(steps),
        }
