"""Large-tree closed loop: all three algorithms at 1000+ scenarios.

BASELINE config 5 regime (1000+ scenarios, ~20k tree nodes).  The XLA
solve switches its stage sweeps from batched cumsums to a sequential
stage scan once a stage holds SCAN_MIN_NS rows (solver/solve_step.py),
and with ``--devices N`` the scenario axis is sharded over N devices,
whose only per-iteration traffic is the distinct-parent psum of the
branching prefix and the global prox norms (parallel/sharding.py).

Run:
    python examples/large_tree.py [--platform cpu|gpu]
        [--scenarios 1024] [--iters 500] [--algorithm proximalAlgorithm]
        [--devices N]
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--scenarios", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--algorithm", default="proximalAlgorithm",
                    choices=["proximalAlgorithm", "globalFbeAlgorithm",
                             "namaAlgorithm"])
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the scenario axis over N devices")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()

    if args.platform:
        from rapidnet_jax.utils.platform import use_platform
        use_platform(args.platform)

    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.solver.controller import SmpcController

    # branching chosen so ns == --scenarios (power-of-2 fan)
    ns = args.scenarios
    branching = []
    while np.prod(branching or [1]) < ns:
        branching.append(2)
    nd, nu = 8, 13
    net = synthetic_network(nx=6, nu=nu, nd=nd, ne=3, seed=3)
    tree = generate_tree(N=12, branching=branching, nd=nd, nu=nu,
                         seed=3)
    fc = synthetic_forecaster(N=12, nd=nd, nu=nu,
                              sim_horizon=args.steps, seed=3)
    cfg = synthetic_config(net, tree, max_iterations=args.iters,
                           step_size=1e-3)
    cfg.algorithm = args.algorithm

    mesh = None
    if args.devices:
        from rapidnet_jax.parallel import make_mesh
        mesh = make_mesh(args.devices)
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          mesh=mesh)
    print(f"tree: {tree.n_nodes} nodes, {tree.ns} scenarios, "
          f"algorithm {args.algorithm}, "
          f"mesh {args.devices or 'none'}")
    for t in range(args.steps):
        t0 = time.perf_counter()
        u = ctrl.control_action(t)
        dt = (time.perf_counter() - t0) * 1e3
        ctrl.move_forward_in_time()
        print(f"t={t}: solve {dt:.1f} ms  u0[:4]={np.round(u[:4], 4)}")
    print("economic KPI", ctrl.economic_kpi(args.steps))


if __name__ == "__main__":
    main()
