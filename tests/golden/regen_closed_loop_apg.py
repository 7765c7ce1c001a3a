"""Regenerate closed_loop_apg.json (run from the repo root on CPU).

Only regenerate when a numerics change is INTENTIONAL — the fixture
exists to catch silent drift in controller/engine plumbing
(tests/test_controller.py::test_closed_loop_golden_trajectory).
"""

import json
import os

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

from rapidnet_jax.model.config import SmpcConfig
from rapidnet_jax.model.forecaster import JsonForecaster
from rapidnet_jax.model.network import DwnNetwork
from rapidnet_jax.model.scenario_tree import ScenarioTree
from rapidnet_jax.solver.controller import SmpcController

F = "/root/reference/src/test/testDataFiles/"
STEPS, ITERS = 4, 100


def main() -> None:
    cfg = SmpcConfig.from_json(F + "controllerConfig.json")
    cfg.max_iterations = ITERS
    ctrl = SmpcController(
        cfg, network=DwnNetwork.from_json(F + "network.json"),
        tree=ScenarioTree.from_json(F + "scenarioTree.json"),
        forecaster=JsonForecaster(F + "forecastor.json"))
    log = ctrl.closed_loop(steps=STEPS)
    out = {"config": "controllerConfig.json", "max_iterations": ITERS,
           "steps": STEPS, "backend": "xla",
           "controls": [log[f"control{t}"] for t in range(STEPS)],
           "economicKpi": log["economicKpi"],
           "smoothKpi": log["smoothKpi"],
           "safetyKpi": log["safetyKpi"],
           "networkKpi": log["networkKpi"],
           "final_state": np.asarray(ctrl.config.current_x).tolist()}
    path = os.path.join(os.path.dirname(__file__),
                        "closed_loop_apg.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
