"""Checkpoint / resume of long closed-loop runs.

The reference's only persistence is the config-JSON state store
(currentX/prevU/prevDemand, src/SmpcConfiguration.cu:240-293).  We keep
that contract (see SmpcController.update_smpc_configuration) and add a
full checkpoint: closed-loop time, state, KPI accumulators, solve-time
history, and (optionally) the last dual iterate for warm starts —
orbax-style as an .npz plus a JSON manifest.
"""

from __future__ import annotations

import json
import os

import numpy as np


def save_checkpoint(controller, path: str, *, sim_time: int,
                    include_duals: bool = True) -> None:
    """Atomic checkpoint: tmp-file + rename for both artifacts, so a
    crash mid-save never corrupts the previous checkpoint."""
    arrays = {
        "current_x": controller.config.current_x,
        "prev_u": controller.config.prev_u,
        "prev_demand": controller.config.prev_demand,
    }
    if include_duals and controller._last is not None:
        y = controller._last["y"]
        for k, v in y.items():
            arrays[f"dual_{k}"] = np.asarray(v)
    tmp = path + ".npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path + ".npz")
    manifest = {
        "sim_time": sim_time,
        "economic_kpi_acc": controller.economic_kpi_acc,
        "smooth_kpi_acc": controller.smooth_kpi_acc,
        "safe_kpi_acc": controller.safe_kpi_acc,
        "network_kpi_acc": controller.network_kpi_acc,
        "solve_times_ms": controller.solve_times_ms,
        "algorithm": controller.config.algorithm,
    }
    tmp = path + ".json.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path + ".json")


def load_checkpoint(controller, path: str) -> int:
    """Restore controller state; returns the sim_time to resume from."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    data = np.load(path + ".npz")
    controller.config.set_current_state(data["current_x"])
    controller.config.set_previous_control(data["prev_u"])
    controller.config.set_previous_demand(data["prev_demand"])
    controller.economic_kpi_acc = manifest["economic_kpi_acc"]
    controller.smooth_kpi_acc = manifest["smooth_kpi_acc"]
    controller.safe_kpi_acc = manifest["safe_kpi_acc"]
    controller.network_kpi_acc = manifest["network_kpi_acc"]
    controller.solve_times_ms = list(manifest["solve_times_ms"])
    duals = {k[len("dual_"):]: data[k] for k in data.files
             if k.startswith("dual_")}
    if duals and controller.warm_start:
        import jax.numpy as jnp
        controller._y_carry = {k: jnp.asarray(v) for k, v in duals.items()}
    return int(manifest["sim_time"])


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path + ".json") and os.path.exists(path + ".npz")
