"""EPANET .inp -> reference-format JSONs -> closed-loop controller.

Pipeline parity with the reference's MATLAB preprocessing
(src/paser/parserEpanet.m + createDwnDataJson.m + generateJsonFile.m),
done natively: parse an EPANET network, build the mass-balance system,
generate a scenario tree from a demand forecaster, export everything in
the reference JSON schemas, then run the controller on the exported
files.

Run:
    python examples/epanet_to_controller.py --inp my_network.inp --out /tmp/dwn
(without --inp a small built-in 3-tank network is used)
"""

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--inp", default=None, help="EPANET .inp file")
    ap.add_argument("--out", default="/tmp/dwn_export")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    args = ap.parse_args()

    if args.platform:
        from rapidnet_jax.utils.platform import use_platform
        use_platform(args.platform)

    import numpy as np

    from rapidnet_jax.io import writers
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.solver.controller import SmpcController
    from rapidnet_jax.solver.tuning import auto_tune

    if args.inp:
        from rapidnet_jax.io.epanet import parse_epanet
        net = parse_epanet(args.inp)
    else:
        from rapidnet_jax.model.network import synthetic_network
        net = synthetic_network(nx=3, nu=6, nd=4, ne=2, seed=1)

    nx, nu, nd = net.nx, net.nu, net.nd
    N = 12
    fc = synthetic_forecaster(N=N, nd=nd, nu=nu, sim_horizon=4, seed=1)
    tree = generate_tree(N=N, branching=[2, 2], nd=nd, nu=nu, seed=1)
    cfg0 = synthetic_config(net, tree, max_iterations=150)
    cfg, _ = auto_tune(net, tree, cfg0)

    paths = writers.export_problem(net, tree, fc, cfg, args.out)
    print("exported reference-format JSONs:")
    for k, v in paths.items():
        print(f"  {k}: {v}")

    # round-trip: build the controller purely from the exported files
    ctrl = SmpcController(paths["config"])
    for t in range(2):
        u = ctrl.control_action(t)
        ctrl.move_forward_in_time()
        print(f"t={t}  u0[:3]={np.round(u[:3], 4)}")
    print("KPIs:", ctrl.economic_kpi(2), ctrl.smooth_kpi(2))


if __name__ == "__main__":
    main()
