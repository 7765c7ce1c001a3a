"""Barcelona-scale synthetic problem with auto-tuning and warm starts.

The reference ships preprocessing for the Barcelona drinking-water
network (src/paser/: 63 tanks, 114 controls) but computes the APG step
size and diagonal preconditioner out-of-band in MATLAB.  This framework
derives both on-device (solver/tuning.py: Jacobi dual preconditioner
from Hutchinson probes of the dual Hessian diagonal + a power-iteration
Lipschitz estimate), so large problems need no offline tooling.

Run:
    python examples/barcelona_scale.py [--platform cpu] [--steps 3]
"""

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--scenarios", type=int, default=25,
                    help="5*ceil(K/5) scenarios via branching [5, K/5]")
    args = ap.parse_args()

    if args.platform:
        from rapidnet_jax.utils.platform import use_platform
        use_platform(args.platform)

    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.solver.controller import SmpcController
    from rapidnet_jax.solver.tuning import auto_tune

    # Barcelona DWN dimensions (reference src/paser/dataSource/dwn.mat)
    net = synthetic_network(nx=63, nu=114, nd=88, ne=17, seed=42)
    b2 = max(args.scenarios // 5, 1)
    tree = generate_tree(N=24, branching=[5, b2], nd=88, nu=114, seed=42)
    fc = synthetic_forecaster(N=24, nd=88, nu=114,
                              sim_horizon=args.steps + 1, seed=42)
    cfg0 = synthetic_config(net, tree, max_iterations=args.iterations)

    t0 = time.perf_counter()
    cfg, engine = auto_tune(net, tree, cfg0)
    print(f"auto-tune (preconditioner + step size): "
          f"{time.perf_counter() - t0:.1f} s, step={cfg.step_size:.3e}")

    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          warm_start=True)
    for t in range(args.steps):
        u = ctrl.control_action(t)
        ctrl.move_forward_in_time()
        print(f"t={t}  solve={ctrl.solve_times_ms[-1]:7.1f} ms  "
              f"final infeasibility "
              f"{abs(ctrl.primal_infeasibility[-1]):.2e}")
    print(f"economic kpi {ctrl.economic_kpi(args.steps):.4f}")


if __name__ == "__main__":
    main()
