"""Benchmark: SMPC solves/s per device on the BASELINE.md ladder config.

Problem: Barcelona-scale synthetic DWN (nx=63 tanks, nu=114 controls,
nd=88 demands, ne=17 junctions), H=24, 556-node scenario tree (25
scenarios), 500 APG iterations per solve — the reference's measurement
unit is wall ms per controlAction at a fixed iteration budget
(src/main.cu:55-59; BASELINE.md).  The dual preconditioner and step
size are auto-tuned (solver/tuning.py), standing in for the reference's
out-of-band MATLAB preprocessing.

The reference publishes no numbers, so vs_baseline is the speedup of
the device over the same XLA program on the host CPU (a child process
pinned to the CPU before JAX starts) — a reproducible self-baseline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", ...}; "device" names the platform, device kind and count and,
on a GPU, the card's name and power limit.

Usage: python bench.py [--platform cpu|gpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPEATS = 7
MAX_ITER = 500
BATCH = 32          # fleet batch size; not yet tuned on a GPU
TTS_RTOL = 1e-2     # time-to-solution tolerance on the stage-0 control,
                    # relative to its converged magnitude (the
                    # reference's own solver-numerics tolerance tier,
                    # src/test/TestSmpcController.cu:31-43; at 1e-3 the
                    # APG control trace's iteration-to-iteration wiggle
                    # sits at the tolerance and nothing "converges")


def build_problem():
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.solver.controller import _factor_arrays, _step_arrays
    from rapidnet_jax.solver.tuning import auto_tune

    nx, nu, nd, ne = 63, 114, 88, 17
    net = synthetic_network(nx=nx, nu=nu, nd=nd, ne=ne, seed=42)
    tree = generate_tree(N=24, branching=[5, 5], nd=nd, nu=nu, seed=42)
    fc = synthetic_forecaster(N=24, nd=nd, nu=nu, sim_horizon=4, seed=42)
    cfg0 = synthetic_config(net, tree, max_iterations=MAX_ITER)
    cfg, eng = auto_tune(net, tree, cfg0)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = _factor_arrays(eng)

    def make_step(x0):
        return _step_arrays(eng.prepare_step(
            fc.nominal_demand, fc.nominal_prices, x0, cfg.prev_u,
            cfg.prev_demand))

    return cfg, eng, fa, make_step, tree


def measure(repeats=REPEATS, include_qn=True):
    import jax

    from rapidnet_jax.engine.engine import XS_UPPER
    from rapidnet_jax.solver import apg as apg_mod
    from rapidnet_jax.utils.platform import device_platform

    cfg, eng, fa, make_step, tree = build_problem()
    kw = dict(
        inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
        penalty_state=cfg.penalty_state, penalty_safety=cfg.penalty_safety,
        xs_upper=float(XS_UPPER), max_iterations=MAX_ITER)
    run_xla = jax.jit(apg_mod.make_apg(
        prefix_stages=eng.factor_step().prefix_stages, **kw))
    on_gpu = device_platform() == "gpu"

    rng = np.random.default_rng(7)
    x0 = cfg.current_x

    def time_path(run):
        out = jax.block_until_ready(run(make_step(x0)))   # warmup/compile
        final_inf = float(np.abs(
            np.asarray(out["primal_infeasibility"])[-10:]).mean())
        times = []
        for _ in range(repeats):
            # perturb the state so every solve is distinct computation
            xr = x0 * (1.0 + 0.02 * rng.standard_normal(x0.shape)
                       ).astype(np.float32)
            step = jax.device_put(make_step(xr))
            # stage inputs on device before the timer: host->device
            # staging overlaps the previous solve in deployment
            jax.block_until_ready(step)
            t0 = time.perf_counter()
            jax.block_until_ready(run(step))
            times.append(time.perf_counter() - t0)
        return float(np.median(times)), final_inf

    p50, final_inf = time_path(lambda step: run_xla(fa, step))

    # Batched throughput: B independent solves per device program
    # (solver/batch.py).  This is the per-device throughput number —
    # batching gives the device larger matmuls than one instance's
    # tiny matrices, and amortises fixed per-call overhead.
    import jax.numpy as jnp

    run_batch = jax.jit(apg_mod.make_apg_batch(
        prefix_stages=eng.factor_step().prefix_stages, **kw))

    def batch_arg():
        steps = [make_step(x0 * (1.0 + 0.02 * rng.standard_normal(
            x0.shape)).astype(np.float32)) for _ in range(BATCH)]
        return {k: jnp.stack([s[k] for s in steps]) for k in steps[0]}

    def time_batch(run_b):
        jax.block_until_ready(run_b(batch_arg()))     # compile + warm
        bt = []
        for _ in range(max(3, repeats // 2)):
            arg = jax.device_put(batch_arg())
            jax.block_until_ready(arg)    # stage inputs (see above)
            t0 = time.perf_counter()
            jax.block_until_ready(run_b(arg))
            bt.append(time.perf_counter() - t0)
        return float(np.median(bt))

    batch_p50 = time_batch(lambda s: run_batch(fa, s))

    # Pipelined throughput: K batch programs enqueued back-to-back,
    # blocking only on the last — the production serving pattern
    # (dispatch of solve k+1 overlaps execution of solve k).  The
    # synchronous number above pays one full host->device->host
    # round trip per program; the pipelined number is the device's
    # sustained rate.
    def time_batch_pipelined(run_b, k=4, rounds=3):
        arg = jax.device_put(batch_arg())
        jax.block_until_ready(arg)
        jax.block_until_ready(run_b(arg))            # compile + warm
        per = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            outs = [run_b(arg) for _ in range(k)]
            jax.block_until_ready(outs[-1])
            per.append((time.perf_counter() - t0) / k)
        return float(np.median(per))

    # (pipelining overlaps host dispatch with device execution; on the
    # in-process CPU path there is nothing to overlap and batch-32 CPU
    # solves take tens of seconds — skip the extra 13 solves there)
    batch_pipe_p50 = (time_batch_pipelined(lambda s: run_batch(fa, s))
                      if on_gpu else batch_p50)

    # Per-algorithm batched throughput at the same 500-iteration budget
    # (the reference treats APG/FBE/NAMA uniformly behind one dispatch,
    # src/SmpcController.cu:63-71; all three test configs use
    # maxIterations=500, lbfgsBufferSize=5).  A quasi-Newton iteration
    # runs 2 extra oracle sweeps + a backtracking line search, so its
    # solves/s is expected below APG's at equal iteration count.
    from rapidnet_jax.solver import quasi_newton
    algo_solves_per_s = {"apg": BATCH / batch_p50}
    for name, algo in (("fbe", "globalFbeAlgorithm"),
                       ("nama", "namaAlgorithm")) if include_qn else ():
        run_qn = jax.jit(quasi_newton.make_solver_batch(
            prefix_stages=eng.factor_step().prefix_stages,
            lbfgs_buffer_size=5, algorithm=algo, **kw))
        algo_solves_per_s[name] = BATCH / time_batch(
            lambda s, r=run_qn: r(fa, s))

    # Time-to-solution: the honest cross-algorithm comparison the fixed
    # 500-iteration budget structurally hides (the reference carries
    # FBE/NAMA for convergence speed, src/SmpcController.cu:1529-1586).
    # The fixed-point residual is the WRONG termination metric here: at
    # the soft-constrained optimum it converges to the nonzero optimal
    # penalty slack, and the dual iterate keeps drifting along the
    # penalised directions — measured, both stall around O(0.1-1)
    # while the CONTROL converges cleanly.  So: solution := u**, the
    # stage-0 control of a 20x-budget (10,000-iteration) APG solve —
    # an anchor INDEPENDENT of the 500-iteration budget (its stability
    # is evidenced by the reported 5k-vs-10k drift); time-to-solution
    # of an algorithm := (its wall ms at budget) x k*/budget, where k*
    # is the first iteration after which its control trace stays
    # within TTS_RTOL * |u**|_inf of u**.  Cold and dual-warm-started
    # (previous solve's duals at a 2%-perturbed state — the
    # receding-horizon deployment pattern).  iterations = null marks
    # an algorithm whose trace never stabilises at u** within budget
    # (an explicit negative result); *_final_dev_vs_anchor states how
    # far each budget answer lands from u**.
    tts = {}
    if include_qn:
        kw_tr = dict(kw, trace_control=True)
        solvers = {"apg": jax.jit(apg_mod.make_apg(
            prefix_stages=eng.factor_step().prefix_stages, **kw_tr))}
        for name, algo in (("fbe", "globalFbeAlgorithm"),
                           ("nama", "namaAlgorithm")):
            solvers[name] = jax.jit(quasi_newton.make_solver(
                prefix_stages=eng.factor_step().prefix_stages,
                lbfgs_buffer_size=5, algorithm=algo, **kw_tr))
        xr = x0 * (1.0 + 0.02 * rng.standard_normal(x0.shape)
                   ).astype(np.float32)
        step0, step1 = make_step(x0), make_step(xr)

        def solve_ms(run, args):
            ts = []
            for _ in range(max(3, repeats // 2)):
                t0 = time.perf_counter()
                out = jax.block_until_ready(run(fa, *args))
                ts.append(time.perf_counter() - t0)
            return out, float(np.median(ts)) * 1e3

        # Independent convergence anchor: u** from
        # a 20x-budget (10k-iteration) APG solve, NOT the 500-iteration
        # answer — keying TTS to the budget answer made APG "converged"
        # by construction.  Anchor stability is evidenced by the
        # 5k-vs-10k answer drift.
        def long_apg(iters):
            run = jax.jit(apg_mod.make_apg(
                prefix_stages=eng.factor_step().prefix_stages,
                **dict(kw, max_iterations=iters)))
            return np.asarray(jax.block_until_ready(
                run(fa, step1))["control"])
        u_5k = long_apg(5000)
        u_star = long_apg(10000)
        anchor_scale = max(float(np.abs(u_star).max()), 1.0)
        anchor = {
            "iterations": 10000,
            "dev_5k_vs_10k": round(float(
                np.abs(u_5k - u_star).max()) / anchor_scale, 5),
        }
        tol_u = TTS_RTOL * anchor_scale
        # budget-escalation ladder: if the control
        # never stabilises at u** within the reference's 500-iteration
        # budget, retry at 2x and 4x so iterations-to-1% is an actual
        # number, not null — the accuracy-normalised claim a control
        # engineer buys the quasi-Newton algorithms for
        budgets = (MAX_ITER, 2 * MAX_ITER, 4 * MAX_ITER)
        algo_ids = {"fbe": "globalFbeAlgorithm",
                    "nama": "namaAlgorithm"}
        built = {}

        def solver_at(name, iters):
            if (name, iters) in built:
                return built[(name, iters)]
            if iters == MAX_ITER:
                run = solvers[name]
            else:
                kw_i = dict(kw, max_iterations=iters,
                            trace_control=True)
                if name == "apg":
                    run = jax.jit(apg_mod.make_apg(
                        prefix_stages=eng.factor_step().prefix_stages,
                        **kw_i))
                else:
                    run = jax.jit(quasi_newton.make_solver(
                        prefix_stages=eng.factor_step().prefix_stages,
                        lbfgs_buffer_size=5, algorithm=algo_ids[name],
                        **kw_i))
            built[(name, iters)] = run
            return run

        def stabilisation(out, budget):
            tr = np.asarray(out["control_trace"])
            err = np.abs(tr - u_star[None]).max(axis=1)
            stable = np.flatnonzero(
                np.maximum.accumulate(err[::-1])[::-1] > tol_u)
            k = int(stable[-1]) + 2 if stable.size else 1
            return k, (k <= budget and err[-1] <= tol_u), err

        for name in solvers:
            out0 = jax.block_until_ready(solvers[name](fa, step0))
            y_warm = out0["y"]
            entry = {}
            for mode, args in (("cold", (step1,)),
                               ("warm", (step1, y_warm))):
                for budget in budgets:
                    out, ms = solve_ms(solver_at(name, budget), args)
                    k, solved, err = stabilisation(out, budget)
                    if budget == MAX_ITER:
                        # reference-budget fields (fixed semantics)
                        entry[f"{mode}_budget_ms"] = round(ms, 3)
                        entry[f"{mode}_final_dev_vs_anchor"] = round(
                            float(err[-1]) / anchor_scale, 5)
                    if solved:
                        break
                entry[f"{mode}_iters"] = k if solved else None
                entry[f"{mode}_ms"] = (round(ms * k / budget, 3)
                                       if solved else None)
                entry[f"{mode}_solved_budget"] = (budget if solved
                                                  else None)
            tts[name] = entry
        tts["anchor"] = anchor

    return {
        "p50_s": p50,
        "solves_per_s": 1.0 / p50,
        "time_to_solution": {"control_rtol": TTS_RTOL, **tts},
        "batch": BATCH,
        "batch_p50_s": batch_p50,
        "batch_solves_per_s": BATCH / batch_p50,
        "batch_pipelined_solves_per_s": BATCH / batch_pipe_p50,
        "tree_nodes": int(tree.n_nodes),
        "scenarios": int(tree.ns),
        "final_infeasibility": final_inf,
        "algo_solves_per_s": {k: round(v, 3)
                              for k, v in algo_solves_per_s.items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="pin the jax platform (default: JAX's choice)")
    args = ap.parse_args(argv)
    from rapidnet_jax.utils import platform
    if args.platform:
        platform.use_platform(args.platform)
    platform.enable_compile_cache()
    device = platform.device_summary()

    if os.environ.get("RAPIDNET_BENCH_CPU_BASELINE") == "1":
        # the CPU self-baseline only feeds vs_baseline for the APG
        # headline; skip the expensive quasi-Newton sweeps there
        res = measure(repeats=3, include_qn=False)
        print(json.dumps(dict(res, device=device)))
        return

    res = measure()
    print(f"[bench] device={device} "
          f"single p50={res['p50_s']*1e3:.2f} ms "
          f"({res['solves_per_s']:.2f} solves/s); "
          f"batch{res['batch']} p50={res['batch_p50_s']*1e3:.2f} ms "
          f"({res['batch_solves_per_s']:.2f} solves/s sync, "
          f"{res['batch_pipelined_solves_per_s']:.2f} pipelined) — "
          f"{res['tree_nodes']}-node tree, {MAX_ITER} iters, "
          f"final infeasibility {res['final_infeasibility']:.3e}, "
          f"per-algorithm {res['algo_solves_per_s']} solves/s",
          file=sys.stderr)
    print(f"[bench] time-to-solution (control rtol {TTS_RTOL:g} vs "
          f"APG-500 answer): {json.dumps(res['time_to_solution'])}",
          file=sys.stderr)

    vs_baseline = 1.0
    if device["platform"] != "cpu":
        # the child is pinned to the CPU before JAX starts, so it never
        # opens the card this process holds
        env = dict(os.environ, RAPIDNET_BENCH_CPU_BASELINE="1",
                   JAX_PLATFORMS="cpu")
        try:
            cp = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--platform", "cpu"],
                capture_output=True, text=True, timeout=2400, env=env,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            cpu = json.loads(cp.stdout.strip().splitlines()[-1])
            vs_baseline = (res["batch_solves_per_s"] /
                           cpu["batch_solves_per_s"])
            print(f"[bench] cpu baseline batch{cpu['batch']} "
                  f"{cpu['batch_solves_per_s']:.2f} solves/s -> "
                  f"speedup {vs_baseline:.2f}x", file=sys.stderr)
        except (subprocess.SubprocessError, ValueError, IndexError,
                KeyError) as exc:
            print(f"[bench] cpu baseline failed: {exc}", file=sys.stderr)

    # Headline metric named for what it measures (batch-32 throughput);
    # the single-solve rate and per-algorithm rates ride along as extra
    # fields so no tracked series silently changes meaning.
    print(json.dumps({
        "metric":
            "smpc_batch32_solves_per_s_per_device_H24_556node_500iter",
        "value": round(res["batch_solves_per_s"], 3),
        "unit": "solves/s",
        "vs_baseline": round(vs_baseline, 3),
        "device": device,
        "single_solve_p50_ms": round(res["p50_s"] * 1e3, 3),
        "single_solves_per_s": round(res["solves_per_s"], 3),
        "batch_pipelined_solves_per_s": round(
            res["batch_pipelined_solves_per_s"], 3),
        "algo_solves_per_s": res["algo_solves_per_s"],
        "time_to_solution": res["time_to_solution"],
    }))


if __name__ == "__main__":
    main()
