"""Closed-loop SMPC over the reference's REAL data.

Two real-data problems from /root/reference/src/paser/dataSource:

1. ``--problem dwn``: the 3-tank network from dwn.mat driven by its
   full year of measured hourly demands and real electricity tariffs
   (io/matio.py) — converted to hourly units (the .mat stores flows
   per second).
2. ``--problem barcelona``: the Barcelona-scale controller
   (controllerConfig32.json: real null-space geometry, costs,
   preconditioner, penalties, initial state) with the real 136-node
   scenario tree (scenarioTree32.json).  Network topology is
   synthetic-deterministic — the reference repo does not ship it
   (io/datasource.py documents per-component provenance).

Usage:
  python examples/real_data_closed_loop.py --problem dwn --steps 24
  python examples/real_data_closed_loop.py --problem barcelona --steps 4
"""

from __future__ import annotations

import argparse

import numpy as np

DS = "/root/reference/src/paser/dataSource"


def run_dwn(steps: int, iters: int, start_hour: int):
    from rapidnet_jax.io.matio import (load_dwn_forecaster,
                                       load_dwn_network)
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.solver.controller import SmpcController

    from rapidnet_jax.solver.tuning import auto_tune

    net = load_dwn_network(DS + "/dwn.mat")
    # units: volumes m^3, controls/demands m^3/s; the .mat's B/Gd
    # already integrate the 3600 s control step (entries are +/-3600)
    N = 24
    tree = generate_tree(N=N, branching=[3], nd=net.nd, nu=net.nu,
                         seed=7, demand_sigma=0.002)
    fc = load_dwn_forecaster(DS + "/dwn.mat", N=N, start=start_hour,
                             hours=N + steps + 1)
    cfg = synthetic_config(net, tree, max_iterations=iters)
    # start just above the safety levels so the controller has to pump
    # (with half-full tanks the economic optimum is u = 0 for hours)
    cfg.current_x = np.maximum(0.12 * net.xmax,
                               1.1 * net.xsafe).astype(np.float32)
    cfg, _ = auto_tune(net, tree, cfg)
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc)


def run_barcelona(steps: int, iters: int):
    from rapidnet_jax.io.datasource import load_barcelona_problem
    from rapidnet_jax.solver.controller import SmpcController

    cfg, net, tree, fc = load_barcelona_problem(
        max_iterations=iters)
    return SmpcController(cfg, network=net, tree=tree, forecaster=fc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=["dwn", "barcelona"],
                    default="dwn")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--start-hour", type=int, default=3000,
                    help="dwn: hour of the year to start at")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    args = ap.parse_args(argv)
    if args.platform:
        from rapidnet_jax.utils.platform import use_platform
        use_platform(args.platform)

    if args.problem == "dwn":
        ctrl = run_dwn(args.steps, args.iterations, args.start_hour)
    else:
        ctrl = run_barcelona(args.steps, args.iterations)

    for t in range(args.steps):
        u = ctrl.control_action(t)
        x = ctrl.move_forward_in_time()
        print(f"t={t}: |u|={np.abs(u).sum():9.3f}  "
              f"x in [{x.min():9.2f}, {x.max():10.2f}]  "
              f"solve {ctrl.solve_times_ms[-1]:7.1f} ms")
    print(f"economic kpi {ctrl.economic_kpi(args.steps):.6f}")
    print(f"smooth   kpi {ctrl.smooth_kpi(args.steps):.6f}")
    print(f"safety   kpi {ctrl.safety_kpi(args.steps):.6f}")
    print(f"network  kpi {ctrl.network_kpi(args.steps):.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
