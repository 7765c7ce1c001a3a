"""Closed-loop CLI driver (reference main.cu parity).

Usage:
  python -m rapidnet_jax.cli --config path/to/controllerConfig.json \
      --steps 10 --output controlOutput.json [--external-simulator]

Runs the receding-horizon loop: forecast -> controlAction (timed) ->
moveForwardInTime, then prints the four KPIs — mirroring
src/main.cu:34-69.  With ``--external-simulator`` the controller
re-reads currentX/prevU/prevDemand from the config JSON each step and
writes the updated state back (the reference's simulatorFlag=0 path,
src/SmpcController.cu:1712-1716 + updateSmpcConfiguration :1725-1773).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True,
                   help="controller configuration JSON "
                        "(reference-compatible)")
    p.add_argument("--steps", type=int, default=2,
                   help="closed-loop time instances to simulate")
    p.add_argument("--output", default="controlOutput.json",
                   help="control output JSON path")
    p.add_argument("--external-simulator", action="store_true",
                   help="read/write closed-loop state via the config "
                        "JSON instead of the built-in simulator")
    p.add_argument("--no-price-uncertainty", action="store_true")
    p.add_argument("--no-demand-uncertainty", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace here")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="pin the jax platform (default: JAX's choice)")
    p.add_argument("--tolerance", type=float, default=None,
                   help="terminate each solve when the residual "
                        "magnitude drops below this (default: fixed "
                        "budget like the reference)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard the scenario axis over this many devices "
                        "(0 = single-device); with jax.distributed "
                        "initialised this spans every process's devices")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from rapidnet_jax.utils import platform
    if args.platform:
        platform.use_platform(args.platform)
    platform.enable_compile_cache()

    from rapidnet_jax.solver.controller import SmpcController

    mesh = None
    if args.devices:
        from rapidnet_jax.parallel import make_mesh
        mesh = make_mesh(args.devices)
    ctrl = SmpcController(args.config, mesh=mesh, tolerance=args.tolerance)
    if args.no_price_uncertainty:
        ctrl.engine.price_uncertainty = False
    if args.no_demand_uncertainty:
        ctrl.engine.demand_uncertainty = False
    ctrl.simulator_flag = not args.external_simulator

    print(f"scenario tree nodes {ctrl.tree.n_nodes} "
          f"{ctrl.tree.ns}", file=sys.stderr)

    if args.profile_dir:
        from rapidnet_jax.utils.timing import profile_trace
        with profile_trace(args.profile_dir):
            log = ctrl.closed_loop(args.steps, output_json=args.output)
    else:
        log = ctrl.closed_loop(args.steps, output_json=args.output)

    print(f"device {platform.device_summary()} solver path "
          f"{ctrl.solver_path}", file=sys.stderr)
    for t in range(args.steps):
        print(f"time lapsed {log[f'time{t}'][0]:.3f} milliseconds",
              file=sys.stderr)
    print(f"economic kpi {log['economicKpi']}")
    print(f"smooth kpi {log['smoothKpi']}")
    print(f"safety kpi {log['safetyKpi']}")
    print(f"network utility kpi {log['networkKpi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
