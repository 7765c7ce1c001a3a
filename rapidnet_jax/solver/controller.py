"""Closed-loop SMPC controller (receding horizon driver).

Reference counterpart: ``SmpcController`` (src/SmpcController.cu) plus
the closed-loop loop of src/main.cu:34-68.  API parity:

  controller = SmpcController(config_path)         # or from objects
  controller.initialise()                          # factor step
  u = controller.control_action(sim_time)          # one solve
  controller.move_forward_in_time()                # built-in simulator
  controller.economic_kpi(T), ...                  # KPI getters

Differences from the reference (intentional):
  * the whole solve (500 APG iterations) is ONE jitted XLA program with
    no host synchronisation (the reference syncs per iteration for the
    prox norms and infeasibility, src/SmpcController.cu:792,810,1487);
  * the built-in simulator applies the demand disturbance e to the state
    update (the reference accidentally adds e to a dead buffer,
    src/SmpcController.cu:1695 — a bug we do not replicate);
  * closed-loop state lives in a plain dataclass with JSON import/export
    instead of rewriting the config file.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rapidnet_jax.engine.engine import XS_UPPER, Engine, StepData
from rapidnet_jax.model.config import (ALGORITHM_APG, ALGORITHM_FBE,
                                       ALGORITHM_NAMA, SmpcConfig)
from rapidnet_jax.model.forecaster import Forecaster, JsonForecaster
from rapidnet_jax.model.network import DwnNetwork
from rapidnet_jax.model.scenario_tree import ScenarioTree
from rapidnet_jax.solver import apg as apg_mod
from rapidnet_jax.utils.platform import device_platform


def _factor_arrays(engine: Engine) -> dict:
    """FactorData -> dict of device arrays for the jitted solvers."""
    fd = engine.factor_step()
    fa = {
        "L": jnp.asarray(fd.L), "B": jnp.asarray(fd.B),
        "Bb": jnp.asarray(fd.Bb), "invWbar": jnp.asarray(fd.invWbar),
        "d1": jnp.asarray(fd.d1), "d2": jnp.asarray(fd.d2),
        "g": jnp.asarray(fd.g),
        "nhp": jnp.asarray(fd.neg_half_over_prob),
        "prob": jnp.asarray(fd.prob),
        "rep": jnp.asarray(fd.rep),
        "xmin": jnp.asarray(fd.xmin), "xmax": jnp.asarray(fd.xmax),
        "xs": jnp.asarray(fd.xs),
        "umin": jnp.asarray(fd.umin), "umax": jnp.asarray(fd.umax),
        "prefix_C": {s: jnp.asarray(C) for s, C in fd.prefix_C.items()},
        "prefix_Cp": {s: jnp.asarray(C) for s, C in fd.prefix_Cp.items()},
        "prefix_Bp": {s: jnp.asarray(B) for s, B in fd.prefix_Bp.items()},
        "Wv": jnp.asarray(engine.Wv),
        "alpha1": jnp.asarray(engine.network.alpha1),
        "W": jnp.asarray(engine.config.cost_w),
        # PHYSICAL control bounds for the final projection — see
        # solve_step.root_control_bounds (deliberate deviation from the
        # reference's projection onto preconditioned bounds)
        "umin_phys": jnp.asarray(engine.network.umin, jnp.float32),
        "umax_phys": jnp.asarray(engine.network.umax, jnp.float32),
    }
    return fa


def _step_arrays(step: StepData) -> dict:
    return {
        "beta": jnp.asarray(step.beta),
        "uhat": jnp.asarray(step.uhat),
        "e": jnp.asarray(step.e),
        "alpha_price": jnp.asarray(step.alpha_price),
        "x0": jnp.asarray(step.x0),
        "prev_u": jnp.asarray(step.prev_u),
        "prev_uhat": jnp.asarray(step.prev_uhat),
    }


class SmpcController:
    def __init__(self, config: SmpcConfig | str,
                 network: Optional[DwnNetwork] = None,
                 tree: Optional[ScenarioTree] = None,
                 forecaster: Optional[Forecaster] = None,
                 warm_start: bool = False,
                 tolerance: Optional[float] = None,
                 mesh=None):
        """The solve is the XLA program of solver/apg.py or
        solver/quasi_newton.py on every supported platform
        (utils/platform.py); ``solver_path`` reports it after
        ``initialise``.

        mesh: optional ``jax.sharding.Mesh`` with a 'scen' axis — the
        closed loop then runs the scenario-axis-sharded shard_map solve
        (all three algorithms) over the mesh, e.g. a multi-process mesh
        built by ``parallel.distributed.scenario_mesh()``.
        """
        if isinstance(config, str):
            config = SmpcConfig.from_json(config)
        self.mesh = mesh
        self.solver_path = None
        self.warm_start = warm_start
        self.tolerance = tolerance
        self._y_carry = None
        self.config = config
        self.network = network or DwnNetwork.from_json(
            config.path_to_network)
        self.tree = tree or ScenarioTree.from_json(
            config.path_to_scenario_tree)
        self.forecaster = forecaster or JsonForecaster(
            config.path_to_forecaster)
        self.engine = Engine(self.network, self.tree, config)

        self.simulator_flag = True
        self._fa = None
        self._solver = None
        self._last = None       # last solve outputs (host copies on demand)
        self._last_control = None
        self.solve_times_ms: list[float] = []

        # KPI accumulators (reference: src/SmpcController.cu:1778-1818)
        self.economic_kpi_acc = 0.0
        self.smooth_kpi_acc = 0.0
        self.safe_kpi_acc = 0.0
        self.network_kpi_acc = 0.0

    # ------------------------------------------------------------------
    def initialise(self) -> None:
        """Factor step + solver compilation (reference:
        initialiseSmpcController, src/SmpcController.cu:476-487)."""
        device_platform(None if self.mesh is None
                        else self.mesh.devices.flat[0])
        self._fa = _factor_arrays(self.engine)
        cfg = self.config
        kw = dict(prefix_stages=self.engine.factor_step().prefix_stages,
                  inv_step=float(1.0 / cfg.step_size),
                  step_size=float(cfg.step_size),
                  penalty_state=float(cfg.penalty_state),
                  penalty_safety=float(cfg.penalty_safety),
                  xs_upper=float(XS_UPPER),
                  max_iterations=int(cfg.max_iterations),
                  tolerance=self.tolerance)
        qn_kw = dict(kw, algorithm=cfg.algorithm,
                     lbfgs_buffer_size=int(cfg.lbfgs_buffer_size))
        if cfg.algorithm not in (ALGORITHM_APG, ALGORITHM_FBE,
                                 ALGORITHM_NAMA):
            raise ValueError(f"unknown algorithm '{cfg.algorithm}'")
        if self.mesh is not None:
            from rapidnet_jax.parallel import (make_sharded_apg,
                                               make_sharded_quasi_newton,
                                               shard_factor_arrays)
            step_t = self.prepare_step(0)     # shape template (host arrays)
            if cfg.algorithm == ALGORITHM_APG:
                self._solver = make_sharded_apg(self.mesh, self._fa, step_t,
                                                **kw)
            else:
                self._solver = make_sharded_quasi_newton(
                    self.mesh, self._fa, step_t, **qn_kw)
            self._fa = shard_factor_arrays(self._fa, self.mesh)
            self.solver_path = "xla+shard_map"
            return
        if cfg.algorithm == ALGORITHM_APG:
            run = apg_mod.make_apg(**kw)
        else:
            from rapidnet_jax.solver import quasi_newton
            run = quasi_newton.make_solver(**qn_kw)
        self._solver = jax.jit(run)
        self.solver_path = "xla"

    # ------------------------------------------------------------------
    def prepare_step(self, sim_time: int) -> dict:
        """Forecast + disturbance elimination for one control step."""
        ok_d = self.forecaster.predict_demand(sim_time)
        ok_p = self.forecaster.predict_prices(sim_time)
        if not (ok_d and ok_p):
            raise IndexError(f"forecaster exhausted at t={sim_time}")
        step = self.engine.prepare_step(
            self.forecaster.nominal_demand, self.forecaster.nominal_prices,
            self.config.current_x, self.config.prev_u,
            self.config.prev_demand)
        return _step_arrays(step)

    def _zero_y(self, step: dict) -> dict:
        """Zero dual pair in the XLA layout (cold start / jit signature)."""
        N, ns = step["beta"].shape[:2]
        nx = self._fa["d1"].shape[-1]
        nu = self._fa["g"].shape[-1]
        return {"xi": jnp.zeros((N, ns, 2 * nx), jnp.float32),
                "psi": jnp.zeros((N, ns, nu), jnp.float32)}

    def control_action(self, sim_time: int) -> np.ndarray:
        """Run one receding-horizon solve; returns the control u0 (nu,)."""
        if self._solver is None:
            self.initialise()
        step = self.prepare_step(sim_time)
        t0 = time.perf_counter()
        if self.mesh is not None:
            from rapidnet_jax.parallel import (shard_dual_arrays,
                                               shard_step_arrays)
            if self._y_carry is None:
                # the shard_map signature is fixed: cold start = zeros
                self._y_carry = shard_dual_arrays(
                    self._zero_y(step), self.mesh)
            out = self._solver(self._fa,
                               shard_step_arrays(step, self.mesh),
                               self._y_carry)
        else:
            # XLA path, all three algorithms: fn(fa, step, y0=None)
            if self.warm_start:
                if self._y_carry is None:
                    # zero warm start keeps the jit signature stable
                    self._y_carry = self._zero_y(step)
                out = self._solver(self._fa, step, self._y_carry)
            else:
                out = self._solver(self._fa, step, None)
        control = np.asarray(jax.block_until_ready(out["control"]))
        self.solve_times_ms.append((time.perf_counter() - t0) * 1e3)
        if self.warm_start:
            self._y_carry = out["y"]
        self._last = out
        self._last_control = control
        return control

    # ------------------------------------------------------------------
    def move_forward_in_time(self) -> np.ndarray:
        """Advance the closed loop by one time instance.

        With ``simulator_flag`` (default) runs the built-in simulator
        x+ = x + B u + Gd d (mass balance; reference moveForewardInTime,
        src/SmpcController.cu:1679-1717, minus its dead-buffer e bug)
        and updates the in-memory state.  Without it, the reference's
        external-simulator contract applies: the updated state is
        written into the config JSON and the (possibly
        externally-modified) state is re-read from it
        (src/SmpcController.cu:1712-1716, SmpcConfiguration
        file-setters :240-293).
        """
        u = self._last_control
        if u is None:
            raise RuntimeError("call control_action first")
        d = self.forecaster.nominal_demand[0]          # realised demand
        x = (self.config.current_x + self.network.matB @ u +
             self.network.matGd @ d).astype(np.float32)
        self._update_kpi(x, u)
        if self.simulator_flag:
            self.config.set_current_state(x)
            self.config.set_previous_control(u)
            self.config.set_previous_demand(d)
        else:
            self.update_smpc_configuration(x, u, d)
            self.reload_state_from_config()
        return x

    # ------------------------------------------------------------------
    # external-simulator JSON state contract
    def update_smpc_configuration(self, state, control, demand,
                                  path: Optional[str] = None) -> None:
        """Write currentX/prevU/prevDemand back into the config JSON
        (reference updateSmpcConfiguration,
        src/SmpcController.cu:1725-1773)."""
        from rapidnet_jax.io import jsonio
        path = path or self.config.path_to_config
        if not path:
            raise ValueError("config has no backing JSON file")
        doc = jsonio.load_json(path)
        doc["currentX"] = np.asarray(state, np.float32).tolist()
        doc["prevU"] = np.asarray(control, np.float32).tolist()
        doc["prevDemand"] = np.asarray(demand, np.float32).tolist()
        jsonio.dump_json(path, doc)

    def reload_state_from_config(self, path: Optional[str] = None) -> None:
        """Re-read closed-loop state from the config JSON (reference
        SmpcConfiguration file-based setters,
        src/SmpcConfiguration.cu:240-293 — without replicating the
        setPreviousDemand-writes-to-prevU bug at :290)."""
        from rapidnet_jax.io import jsonio
        path = path or self.config.path_to_config
        doc = jsonio.load_json(path)
        self.config.set_current_state(
            np.asarray(doc["currentX"], np.float32))
        self.config.set_previous_control(
            np.asarray(doc["prevU"], np.float32))
        self.config.set_previous_demand(
            np.asarray(doc["prevDemand"], np.float32))

    def _update_kpi(self, state: np.ndarray, control: np.ndarray) -> None:
        net, cfg = self.network, self.config
        prices = self.forecaster.nominal_prices[0]
        eco = float(np.sum(cfg.weight_economical *
                           (net.alpha1 + prices) * np.abs(control)))
        du = cfg.prev_u - control
        smooth = float(du @ du)
        level = np.minimum(state - net.xsafe, 0.0)
        safe = float(np.abs(level).sum())
        netk = float(np.abs(state).sum())
        self.economic_kpi_acc += eco
        self.smooth_kpi_acc += smooth
        self.safe_kpi_acc += safe
        self.network_kpi_acc += netk

    # KPI getters (reference: src/SmpcController.cu:1824-1859)
    def economic_kpi(self, sim_time: int) -> float:
        return self.economic_kpi_acc / 3600.0 / max(sim_time, 1)

    def smooth_kpi(self, sim_time: int) -> float:
        return self.smooth_kpi_acc / 3600.0 / max(sim_time, 1)

    def safety_kpi(self, sim_time: int) -> float:
        return self.safe_kpi_acc

    def network_kpi(self, sim_time: int) -> float:
        safe_norm = float(np.sum(self.network.xsafe))
        if self.network_kpi_acc == 0:
            return 0.0
        return 100.0 * max(sim_time, 1) * safe_norm / self.network_kpi_acc

    def live_buffer_count(self) -> int:
        """Number of live device arrays (leak-invariant probe).

        Device analog of the reference's cudaMemGetInfo leak check
        (src/SmpcController.cu:1612-1624): the buffer census must be
        stable across solves once the solver is warm.
        """
        return len(jax.live_arrays())

    # ------------------------------------------------------------------
    def closed_loop(self, steps: int, output_json: Optional[str] = None
                    ) -> dict:
        """Run a closed-loop simulation (reference main.cu:45-69).

        Mirrors the reference's per-solve memory-leak invariant
        (src/SmpcController.cu:1612-1624): the live device-buffer count
        must not grow across warm solves; growth is reported in the log
        (the reference prints "RUNTIME ERROR: MEMORY LEAKS").
        """
        log = {}
        buffers0 = None
        for t in range(steps):
            u = self.control_action(t)
            if t == 0:
                buffers0 = self.live_buffer_count()   # post-warmup census
            log[f"control{t}"] = u.tolist()
            log[f"time{t}"] = [self.solve_times_ms[-1]]
            self.move_forward_in_time()
        if steps > 1 and buffers0 is not None:
            growth = self.live_buffer_count() - buffers0
            if growth > 0:
                log["memoryLeakWarning"] = (
                    f"RUNTIME ERROR: MEMORY LEAKS ({growth} device "
                    f"buffers gained across {steps - 1} warm solves)")
                print(log["memoryLeakWarning"], file=sys.stderr)
        log["economicKpi"] = self.economic_kpi(steps)
        log["smoothKpi"] = self.smooth_kpi(steps)
        log["safetyKpi"] = self.safety_kpi(steps)
        log["networkKpi"] = self.network_kpi(steps)
        if output_json:
            with open(output_json, "w") as f:
                json.dump(log, f, indent=1)
        return log

    # diagnostics
    @property
    def primal_infeasibility(self) -> np.ndarray:
        if self._last is None:
            return np.zeros(0, np.float32)
        return np.asarray(self._last["primal_infeasibility"])
