"""Real multi-process distributed test (2 OS processes = 2 "hosts").

The reference is strictly single-GPU; SURVEY §4 calls for real
multi-host tests in the rebuild.  This spawns two coordinator-connected
jax.distributed processes (gloo CPU collectives, 2 virtual devices
each), runs the scenario-sharded APG solve over the 4-device global
mesh with each process feeding only its own scenario block, and checks
the control against the single-process solve.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(__file__), "_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_solve(tmp_path):
    out_path = str(tmp_path / "dist_out.npz")
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), out_path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    codes = [p.returncode for p in procs]
    if any(c == 3 for c in codes):
        pytest.skip("jax.distributed gloo CPU collectives unavailable: "
                    + outs[0][1][-500:])
    for (stdout, stderr), code in zip(outs, codes):
        assert code == 0, f"worker failed (rc={code}):\n{stderr[-2000:]}"

    # single-process reference on the local virtual mesh
    import jax

    from tests._dist_worker import build_problem
    from rapidnet_jax.solver import apg as apg_mod

    fa, step, kw = build_problem()
    ref = jax.jit(apg_mod.make_apg(**kw))(fa, step)

    got = np.load(out_path)
    np.testing.assert_allclose(got["control"], np.asarray(ref["control"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        got["infeas"], np.asarray(ref["primal_infeasibility"]),
        rtol=1e-3, atol=1e-4)


def test_two_process_controller_mesh_closed_loop(tmp_path):
    """The documented multi-host recipe end-to-end: SmpcController with
    mesh= over 2 coordinator-connected processes (the staging helpers
    assemble each host's scenario block), compared against the
    single-process mesh closed loop (ADVICE r1: the controller mesh
    path was previously only exercised single-process)."""
    out_path = str(tmp_path / "dist_ctrl.npz")
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), out_path,
             "controller"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    codes = [p.returncode for p in procs]
    if any(c == 3 for c in codes):
        pytest.skip("jax.distributed gloo CPU collectives unavailable: "
                    + outs[0][1][-500:])
    for (stdout, stderr), code in zip(outs, codes):
        assert code == 0, f"worker failed (rc={code}):\n{stderr[-2000:]}"

    # single-process reference: same controller over the local mesh
    from rapidnet_jax.parallel import make_mesh
    from rapidnet_jax.solver.controller import SmpcController
    from tests._dist_worker import build_controller_problem

    cfg, net, tree, fc = build_controller_problem()
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                          mesh=make_mesh(4))
    ref = []
    for t in range(2):
        ref.append(ctrl.control_action(t))
        ctrl.move_forward_in_time()

    got = np.load(out_path)
    np.testing.assert_allclose(got["c0"], ref[0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["c1"], ref[1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["x"],
                               np.asarray(ctrl.config.current_x),
                               rtol=2e-4, atol=2e-4)


def test_two_process_2d_batch_scen_mesh(tmp_path):
    """BASELINE config 5's batched multi-host shape across real
    processes: a 2-D (batch, scen) mesh over 2 coordinator-connected
    processes, staged by the generic per-device shard assembly
    (round 2 raised NotImplementedError here).  Controls must match
    the unsharded batched solve."""
    out_path = str(tmp_path / "dist_b2d.npz")
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), out_path,
             "batch2d"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    codes = [p.returncode for p in procs]
    if any(c == 3 for c in codes):
        pytest.skip("jax.distributed gloo CPU collectives unavailable: "
                    + outs[0][1][-500:])
    for (stdout, stderr), code in zip(outs, codes):
        assert code == 0, f"worker failed (rc={code}):\n{stderr[-2000:]}"

    # unsharded batched reference (independent code path)
    import jax

    from rapidnet_jax.solver import apg as apg_mod
    from tests._dist_worker import build_batch2d_steps, build_problem

    fa, step, kw = build_problem()
    steps = build_batch2d_steps(step)
    ref = jax.jit(apg_mod.make_apg_batch(**kw))(fa, steps)
    got = np.load(out_path)
    assert got["controls"].shape == np.asarray(ref["control"]).shape
    np.testing.assert_allclose(got["controls"],
                               np.asarray(ref["control"]),
                               rtol=2e-4, atol=2e-4)


def test_two_process_quasi_newton_solve(tmp_path):
    """Scenario-sharded FBE across 2 real processes matches the
    single-process single-device FBE solve."""
    out_path = str(tmp_path / "dist_qn.npz")
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), out_path,
             "qn"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    codes = [p.returncode for p in procs]
    if any(c == 3 for c in codes):
        pytest.skip("jax.distributed gloo CPU collectives unavailable: "
                    + outs[0][1][-500:])
    for (stdout, stderr), code in zip(outs, codes):
        assert code == 0, f"worker failed (rc={code}):\n{stderr[-2000:]}"

    import jax

    from rapidnet_jax.solver import quasi_newton
    from tests._dist_worker import QN_KW, build_problem

    fa, step, kw = build_problem()
    ref = jax.jit(quasi_newton.make_solver(**dict(kw, **QN_KW)))(fa, step)
    got = np.load(out_path)
    np.testing.assert_allclose(got["control"], np.asarray(ref["control"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["tau"], np.asarray(ref["tau"]),
                               rtol=1e-4, atol=1e-5)
