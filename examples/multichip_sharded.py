"""Scenario-axis sharded solve over a device mesh.

The scenario (fan-layout slot) axis is sharded with ``shard_map`` over
a 1-D ``jax.sharding.Mesh``; the non-branching tail of both tree sweeps
is shard-local, the branching-prefix child->parent reductions and the
global prox norms are collectives (parallel/sharding.py).

Run on N GPUs, or rehearse on N virtual CPU devices:
    python examples/multichip_sharded.py [--devices 4]
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip_sharded.py [--devices 8]
"""

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--iterations", type=int, default=100)
    args = ap.parse_args()

    import jax
    import numpy as np

    from rapidnet_jax.engine.engine import XS_UPPER, Engine
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.parallel import sharding
    from rapidnet_jax.solver.controller import _factor_arrays, _step_arrays

    D = args.devices
    net = synthetic_network(nx=16, nu=30, nd=20, ne=5, seed=3)
    # ns must be divisible by the mesh size; branching [D, 4] gives 4D
    tree = generate_tree(N=12, branching=[D, 4], nd=20, nu=30, seed=3)
    fc = synthetic_forecaster(N=12, nd=20, nu=30, sim_horizon=2, seed=3)
    cfg = synthetic_config(net, tree, max_iterations=args.iterations,
                           step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = _factor_arrays(eng)
    step = _step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, cfg.current_x, cfg.prev_u,
        cfg.prev_demand))

    mesh = sharding.make_mesh(D)
    print(f"mesh: {mesh} ({tree.ns} scenarios, "
          f"{tree.ns // D} per device)")
    fa_sh = sharding.shard_factor_arrays(fa, mesh)
    step_sh = sharding.shard_step_arrays(step, mesh)
    run = sharding.make_sharded_apg(
        mesh, fa, step,
        prefix_stages=eng.factor_step().prefix_stages,
        inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
        penalty_state=cfg.penalty_state, penalty_safety=cfg.penalty_safety,
        xs_upper=float(XS_UPPER), max_iterations=args.iterations)
    out = jax.block_until_ready(run(fa_sh, step_sh))
    print("control u0:", np.asarray(out["control"])[:6])
    print("u sharding:", out["u"].sharding)
    print("final infeasibility:",
          abs(np.asarray(out["primal_infeasibility"])[-1]))


if __name__ == "__main__":
    main()
