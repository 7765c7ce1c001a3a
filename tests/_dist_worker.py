"""Worker process for the real multi-process distributed test.

Launched by tests/test_distributed.py as N separate OS processes, each
playing one host of a multi-host mesh: jax.distributed.initialize over a
local TCP coordinator, gloo CPU collectives, 2 virtual devices per
process.  Each process materialises ONLY its own scenario block
(shard_problem_multihost) — the data path a real multi-host deployment
uses — then runs the shard_map APG solve over the global mesh.

Usage: python _dist_worker.py <pid> <nproc> <port> <out.npz>
"""

import os
import sys


def build_problem():
    """Deterministic synthetic problem, identical on every process
    (ns=16 scenarios; mirrors the tests/test_sharding.py fixture)."""
    from rapidnet_jax.engine.engine import XS_UPPER, Engine
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.solver.controller import _factor_arrays, _step_arrays

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=11)
    tree = generate_tree(N=10, branching=[4, 2, 2], nd=3, nu=7, seed=11)
    fc = synthetic_forecaster(N=10, nd=3, nu=7, sim_horizon=4, seed=11)
    cfg = synthetic_config(net, tree, max_iterations=40, step_size=1e-3)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = _factor_arrays(eng)
    step = _step_arrays(eng.prepare_step(
        fc.nominal_demand, fc.nominal_prices, cfg.current_x, cfg.prev_u,
        cfg.prev_demand))
    kw = dict(prefix_stages=eng.factor_step().prefix_stages,
              inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
              penalty_state=cfg.penalty_state,
              penalty_safety=cfg.penalty_safety,
              xs_upper=float(XS_UPPER),
              max_iterations=cfg.max_iterations)
    return fa, step, kw


# FBE settings of the quasi-Newton mode (short budget: the line search
# takes hard branches on global dots, see tests/test_sharding.py)
QN_KW = dict(algorithm="globalFbeAlgorithm", lbfgs_buffer_size=4,
             max_iterations=15)


def build_controller_problem():
    """Deterministic synthetic problem for the controller-mesh mode."""
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree

    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=11)
    tree = generate_tree(N=10, branching=[4, 2, 2], nd=3, nu=7, seed=11)
    fc = synthetic_forecaster(N=10, nd=3, nu=7, sim_horizon=4, seed=11)
    cfg = synthetic_config(net, tree, max_iterations=40, step_size=1e-3)
    return cfg, net, tree, fc


def run_controller(out_path: str, pid: int) -> None:
    """The documented multi-host recipe: SmpcController(mesh=...) over a
    multi-process mesh — every host runs the identical closed loop; the
    staging helpers feed each host's scenario block
    (parallel.sharding._put -> distributed._make_global)."""
    import numpy as np

    from rapidnet_jax.parallel.distributed import scenario_mesh
    from rapidnet_jax.solver.controller import SmpcController

    cfg, net, tree, fc = build_controller_problem()
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          mesh=scenario_mesh())
    controls = []
    for t in range(2):
        controls.append(ctrl.control_action(t))
        ctrl.move_forward_in_time()
    if pid == 0:
        np.savez(out_path, c0=controls[0], c1=controls[1],
                 x=np.asarray(ctrl.config.current_x))


def run_quasi_newton(out_path: str, pid: int) -> None:
    """Scenario-sharded FBE across real processes: the L-BFGS dots, FBE
    value and line-search decisions are global psums, so every process
    must take the same branches."""
    import numpy as np

    from rapidnet_jax.parallel import make_sharded_quasi_newton
    from rapidnet_jax.parallel.distributed import (
        scenario_mesh, shard_problem_multihost)

    fa, step, kw = build_problem()
    kw = dict(kw, **QN_KW)
    mesh = scenario_mesh()
    fa_sh, step_sh = shard_problem_multihost(mesh, fa, step)
    run = make_sharded_quasi_newton(mesh, fa, step, **kw)
    out = run(fa_sh, step_sh)
    control = np.asarray(out["control"])          # replicated
    tau = np.asarray(out["tau"])
    if pid == 0:
        np.savez(out_path, control=control, tau=tau)


def build_batch2d_steps(step: dict) -> dict:
    """Two deterministic problem instances (B=2) from the base step."""
    import numpy as np

    rng = np.random.default_rng(5)
    steps = {}
    for k, v in step.items():
        v = np.asarray(v)
        pert = (v * (1.0 + 0.05 * rng.standard_normal(v.shape))
                ).astype(v.dtype)
        steps[k] = np.stack([v, pert])
    return steps


def run_batch2d(out_path: str, pid: int) -> None:
    """Multi-process 2-D (batch x scen) mesh: B=2 problem instances
    data-parallel over BATCH_AXIS, each instance's scenario tree
    sharded over AXIS, across 2 processes (BASELINE config 5's batched
    multi-host shape).  Staging goes through the generic per-device
    shard assembly (parallel.sharding._put -> distributed._make_global),
    which round-2 explicitly did not implement for batch specs."""
    import jax
    import numpy as np

    from rapidnet_jax.parallel import (make_mesh_2d,
                                       make_sharded_apg_batch,
                                       shard_factor_arrays,
                                       shard_step_arrays_batch)

    fa, step, kw = build_problem()
    steps = build_batch2d_steps(step)
    mesh = make_mesh_2d(2, 2)
    fa_sh = shard_factor_arrays(fa, mesh)
    steps_sh = shard_step_arrays_batch(steps, mesh)
    run = make_sharded_apg_batch(mesh, fa, step, **kw)
    out = run(fa_sh, steps_sh)
    # the (B, nu) controls are batch-sharded across processes; gather
    # the global value on every host before saving
    from jax.experimental import multihost_utils
    controls = np.asarray(
        multihost_utils.process_allgather(out["control"], tiled=True))
    if pid == 0:
        np.savez(out_path, controls=controls)


def main(pid: int, nproc: int, port: int, out_path: str,
         mode: str = "solve") -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    try:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=nproc, process_id=pid)
    except Exception as exc:  # runtime lacks gloo — signal a skip
        print(f"DIST_INIT_FAILED: {exc}", file=sys.stderr)
        return 3

    import numpy as np

    from rapidnet_jax.parallel import make_sharded_apg
    from rapidnet_jax.parallel.distributed import (
        scenario_mesh, shard_problem_multihost)

    assert jax.process_count() == nproc
    assert len(jax.devices()) == 2 * nproc

    if mode == "controller":
        run_controller(out_path, pid)
        jax.distributed.shutdown()
        return 0
    if mode == "batch2d":
        run_batch2d(out_path, pid)
        jax.distributed.shutdown()
        return 0
    if mode == "qn":
        run_quasi_newton(out_path, pid)
        jax.distributed.shutdown()
        return 0

    fa, step, kw = build_problem()
    mesh = scenario_mesh()
    fa_sh, step_sh = shard_problem_multihost(mesh, fa, step)
    run = make_sharded_apg(mesh, fa, step, **kw)
    out = run(fa_sh, step_sh)
    control = np.asarray(out["control"])          # replicated
    infeas = np.asarray(out["primal_infeasibility"])
    if pid == 0:
        np.savez(out_path, control=control, infeas=infeas)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4],
                  sys.argv[5] if len(sys.argv) > 5 else "solve"))
