"""Batched Monte-Carlo closed-loop evaluation (BASELINE config #5).

Evaluates one SMPC controller over B perturbed initial conditions and
per-instance demand realisations SIMULTANEOUSLY: each time step runs
ONE batched device solve (vmapped XLA solve) for all instances, then
every instance's plant advances independently.  This is the "batched
receding-horizon closed-loop runs" scale axis — the reference (one GPU,
one instance per process, src/main.cu:34-68) has no counterpart; it is
the main per-device throughput lever.

Run:
    python examples/batched_monte_carlo.py [--platform cpu]
        [--batch 8] [--steps 4]
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=150)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    args = ap.parse_args()
    if args.platform:
        from rapidnet_jax.utils.platform import use_platform
        use_platform(args.platform)

    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.solver.batch import BatchedSmpcController

    nx, nu, nd, ne, N = 10, 18, 12, 4, 12
    net = synthetic_network(nx=nx, nu=nu, nd=nd, ne=ne, seed=1)
    tree = generate_tree(N=N, branching=[3, 2], nd=nd, nu=nu, seed=1)
    cfg = synthetic_config(net, tree, max_iterations=args.iterations,
                           step_size=1e-3)

    # B perturbed initial tank levels + B demand realisations
    rng = np.random.default_rng(0)
    x0s = cfg.current_x * (0.8 + 0.4 * rng.random((args.batch, nx)))
    forecasters = [
        synthetic_forecaster(N=N, nd=nd, nu=nu,
                             sim_horizon=args.steps + 2, seed=100 + b)
        for b in range(args.batch)
    ]

    bctrl = BatchedSmpcController(cfg, net, tree, forecasters, x0s)
    t0 = time.perf_counter()
    log = bctrl.closed_loop(args.steps)
    wall = time.perf_counter() - t0

    n_solves = args.batch * args.steps
    print(f"{n_solves} solves ({args.batch} instances x {args.steps} "
          f"steps) in {wall:.2f}s -> {n_solves / wall:.1f} solves/s")
    print(f"controls shape {log['controls'].shape}")
    print(f"economic KPI  mean {log['economicKpi'].mean():.4f}  "
          f"spread [{log['economicKpi'].min():.4f}, "
          f"{log['economicKpi'].max():.4f}]")
    print(f"safety  KPI   mean {log['safetyKpi'].mean():.4f}")
    print(f"network KPI   mean {log['networkKpi'].mean():.2f}")
    assert np.all(np.isfinite(log["controls"]))
    print("OK")


if __name__ == "__main__":
    main()
