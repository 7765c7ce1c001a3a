"""BASELINE.md config-ladder benchmark (configs 1-5).

Runs the full measurement ladder from BASELINE.json on the default
JAX device (or --platform) and writes ladder.json:

  1. deterministic 1-scenario 3-tank toy, H=8          (CPU path)
  2. binary tree (~25 nodes), H=12                     (default backend)
  3. Barcelona-subset, ~100-node tree, H=24            (default backend)
  4. Barcelona-scale, 556-node tree, H=24              (default backend,
     single + batched throughput — bench.py's headline config)
  5. 1024-scenario tree (20.8k nodes), H=24            (default backend;
     plus scenario-weak-scaling efficiency vs config 4's per-scenario
     rate, and a sharded-mesh execution check:
     the same solve through shard_map on a 1-device mesh, quantifying
     the shard_map overhead on one device)

Every result file names the device it ran on (platform, device kind,
count and, on a GPU, the card's name and power limit).  Besides the
single-device rows the ladder records:

  * ``device_scaling``: the 1024-scenario solve sharded over 1/2/4/8
    virtual CPU devices (subprocess with
    --xla_force_host_platform_device_count).  Virtual devices share
    the host's physical cores, so ideal scaling is flat ms (the work
    is constant and the cores are shared); what the table shows is
    the *overhead* the mesh partitioning + collectives add.
  * ``collectives``: per-iteration collective ops/bytes of the
    compiled 8-device program, read from the optimized HLO.

Usage: python bench_ladder.py [--platform cpu|gpu] [--repeats 5]
                              [--out ladder.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

MAX_ITER = 500
CONFIG5 = dict(dims=(63, 114, 88, 17), N=24, branching=[8, 8, 4, 4])


def _build(nx, nu, nd, ne, N, branching, *, seed=42, tune=True,
           max_iter=MAX_ITER):
    from rapidnet_jax.engine.engine import Engine
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.solver.controller import _factor_arrays, _step_arrays
    from rapidnet_jax.solver.tuning import auto_tune

    net = synthetic_network(nx=nx, nu=nu, nd=nd, ne=ne, seed=seed)
    tree = generate_tree(N=N, branching=list(branching), nd=nd, nu=nu,
                         seed=seed)
    fc = synthetic_forecaster(N=N, nd=nd, nu=nu, sim_horizon=4, seed=seed)
    cfg0 = synthetic_config(net, tree, max_iterations=max_iter)
    if tune:
        cfg, eng = auto_tune(net, tree, cfg0)
    else:
        cfg, eng = cfg0, Engine(net, tree, cfg0)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = _factor_arrays(eng)

    def make_step(x0):
        return _step_arrays(eng.prepare_step(
            fc.nominal_demand, fc.nominal_prices, x0, cfg.prev_u,
            cfg.prev_demand))

    return cfg, eng, fa, make_step, tree


def _build_real(max_iter=None):
    """REAL Barcelona-scale problem from the reference's dataSource
    (io/datasource.py): real matL/matLhat/costW/preconditioner/
    penalties/step/initial state + the real 136-node scenario tree
    with real uncertainty vectors; topology/bounds synthetic
    (provenance: datasource.BARCELONA_PROVENANCE — the reference does
    not ship its Barcelona network.json)."""
    from rapidnet_jax.engine.engine import Engine
    from rapidnet_jax.io.datasource import load_barcelona_problem
    from rapidnet_jax.solver.controller import _factor_arrays, _step_arrays

    cfg, net, tree, fc = load_barcelona_problem(
        max_iterations=max_iter or MAX_ITER)
    eng = Engine(net, tree, cfg)
    fc.predict_demand(0)
    fc.predict_prices(0)
    fa = _factor_arrays(eng)

    def make_step(x0):
        return _step_arrays(eng.prepare_step(
            fc.nominal_demand, fc.nominal_prices, x0, cfg.prev_u,
            cfg.prev_demand))

    return cfg, eng, fa, make_step, tree


def _solver_kw(cfg):
    from rapidnet_jax.engine.engine import XS_UPPER
    return dict(inv_step=1.0 / cfg.step_size, step_size=cfg.step_size,
                penalty_state=cfg.penalty_state,
                penalty_safety=cfg.penalty_safety,
                xs_upper=float(XS_UPPER),
                max_iterations=cfg.max_iterations)


def _solver(cfg, eng, fa, *, batch=None):
    import jax

    from rapidnet_jax.solver import apg as apg_mod

    kw = _solver_kw(cfg)
    prefix_stages = eng.factor_step().prefix_stages
    if batch:
        run = apg_mod.make_apg_batch(prefix_stages=prefix_stages, **kw)
    else:
        run = apg_mod.make_apg(prefix_stages=prefix_stages, **kw)
    jrun = jax.jit(run)
    return (lambda steps: jrun(fa, steps)), "xla"


def _time(fn, arg, repeats):
    import jax
    arg = jax.device_put(arg)
    jax.block_until_ready(arg)              # stage inputs on device
    jax.block_until_ready(fn(arg))          # compile + warm
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def _rand_x0(cfg, rng):
    return (cfg.current_x *
            (0.9 + 0.2 * rng.random(cfg.current_x.shape))).astype(np.float32)


def run_config(name, dims, N, branching, repeats, *, batch=None,
               tune=True, problem=None,
               data="synthetic"):
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    if problem is None:
        problem = _build(*dims, N, branching, tune=tune,
                         max_iter=MAX_ITER)
    cfg, eng, fa, make_step, tree = problem
    fn, path = _solver(cfg, eng, fa, batch=batch)
    if batch:
        steps = [make_step(_rand_x0(cfg, rng)) for _ in range(batch)]
        arg = {k: jnp.stack([s[k] for s in steps]) for k in steps[0]}
        ms = _time(fn, arg, repeats)
        solves_s = batch * 1e3 / ms
    else:
        arg = make_step(_rand_x0(cfg, rng))
        ms = _time(fn, arg, repeats)
        solves_s = 1e3 / ms
    rec = {"config": name, "nodes": int(tree.n_nodes),
           "scenarios": int(tree.ns), "N": int(N),
           "iters": MAX_ITER, "path": path, "data": data,
           "batch": batch or 1, "p50_ms": round(ms, 3),
           "solves_per_s": round(solves_s, 3)}
    print(json.dumps(rec))
    return rec, problem


def sharded_overhead_row(problem, repeats):
    """Config-5 solve through shard_map on a 1-device mesh: isolates
    the shard_map partitioning/dispatch overhead vs the plain jit path
    on the same device."""
    import jax

    from rapidnet_jax.parallel import (make_mesh, make_sharded_apg,
                                       shard_factor_arrays,
                                       shard_step_arrays)
    cfg, eng, fa, make_step, tree = problem
    rng = np.random.default_rng(7)
    step = make_step(_rand_x0(cfg, rng))
    mesh = make_mesh(1)
    fa_sh = shard_factor_arrays(fa, mesh)
    step_sh = shard_step_arrays(step, mesh)
    fn = make_sharded_apg(mesh, fa, step,
                          prefix_stages=eng.factor_step().prefix_stages,
                          **_solver_kw(cfg))
    jax.block_until_ready(fn(fa_sh, step_sh))      # compile + warm
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(fa_sh, step_sh))
        ts.append(time.perf_counter() - t0)
    ms = float(np.median(ts) * 1e3)
    rec = {"config": "5_1024scenario_H24_shardmap_1dev",
           "nodes": int(tree.n_nodes), "scenarios": int(tree.ns),
           "iters": MAX_ITER, "path": "xla+shard_map", "batch": 1,
           "p50_ms": round(ms, 3), "solves_per_s": round(1e3 / ms, 3)}
    print(json.dumps(rec))
    return rec


# ----------------------------------------------------------------------
# virtual-mesh scaling + collective-bytes evidence (subprocess: the
# host-platform device count must be fixed before the backend starts)

def _device_scaling_child(n_dev: int, iters: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) >= n_dev, (len(jax.devices()), n_dev)
    import re

    from rapidnet_jax.parallel import (make_mesh, make_sharded_apg,
                                       shard_factor_arrays,
                                       shard_step_arrays)
    cfg, eng, fa, make_step, tree = _build(
        *CONFIG5["dims"], CONFIG5["N"], CONFIG5["branching"],
        max_iter=iters)
    rng = np.random.default_rng(7)
    step = make_step(_rand_x0(cfg, rng))
    mesh = make_mesh(n_dev)
    fa_sh = shard_factor_arrays(fa, mesh)
    step_sh = shard_step_arrays(step, mesh)
    fn = make_sharded_apg(mesh, fa, step,
                          prefix_stages=eng.factor_step().prefix_stages,
                          **_solver_kw(cfg))
    jax.block_until_ready(fn(fa_sh, step_sh))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(fa_sh, step_sh))
        ts.append(time.perf_counter() - t0)
    ms = float(np.median(ts) * 1e3)
    out = {"n_devices": n_dev, "p50_ms": round(ms, 3),
           "min_ms": round(float(np.min(ts) * 1e3), 3),
           "ms_per_iter": round(ms / iters, 4),
           "oversubscribed": n_dev > (os.cpu_count() or 1)}

    # per-iteration collective census: compile a ONE-iteration sharded
    # solve and count every collective in its optimized HLO — each
    # per-iteration collective appears exactly once (docs/multihost.md
    # evidence vs the "few kB per iteration" claim)
    if n_dev > 1:
        try:
            kw1 = dict(_solver_kw(cfg), max_iterations=1)
            fn1 = make_sharded_apg(
                mesh, fa, step,
                prefix_stages=eng.factor_step().prefix_stages, **kw1)
            import jax as _jax
            hlo = _jax.jit(lambda a, b: fn1(a, b)).lower(
                fa_sh, step_sh).compile().as_text()
            ops = {}
            bytes_total = 0
            # lines like: %all-gather.3 = f32[24,1024,63] all-gather(...)
            pat = re.compile(
                r"(f32|bf16)\[([\d,]*)\][^\n=]*?\b(all-gather|"
                r"all-reduce|collective-permute|reduce-scatter)\(")
            for m in pat.finditer(hlo):
                dt, shape, op = m.groups()
                n = int(np.prod([int(x) for x in shape.split(",")
                                 if x])) if shape else 1
                ops[op] = ops.get(op, 0) + 1
                bytes_total += (2 if dt == "bf16" else 4) * n
            out["collectives_per_iteration"] = ops
            out["collective_bytes_per_iteration"] = int(bytes_total)
        except Exception as exc:  # noqa: BLE001
            out["collectives_error"] = str(exc)[:200]
    print("CHILD:" + json.dumps(out))


def device_scaling_table(iters: int = 50) -> dict:
    """Run the 1024-scenario sharded solve on 1..8 virtual CPU devices
    in fresh subprocesses (XLA_FLAGS must precede backend start).

    Methodology: an n-device child is pinned
    to min(n, host_cores) physical cores with ``taskset`` (XLA's CPU
    thread-count flags are ignored by the current thunk runtime —
    verified: a large matmul times identically with and without them).
    CPU resources therefore scale WITH the device count up to the core
    count: those points measure STRONG scaling (ideal ms = t1/n);
    device counts above the core count are oversubscribed — they
    validate functionality and count collectives but their timings
    support no scaling conclusion (labelled `oversubscribed`, excluded
    from the efficiency metric).  5 repeats per point, median + min.
    """
    cores = os.cpu_count() or 1
    table = []
    for n in (1, 2, 4, 8):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                       f" --xla_force_host_platform_device_count={n}"))
        pin = ",".join(str(c) for c in range(min(n, cores)))
        cp = subprocess.run(
            ["taskset", "-c", pin,
             sys.executable, os.path.abspath(__file__),
             "--device-scaling-child", str(n),
             "--max-iter", str(iters)],
            capture_output=True, text=True, timeout=1800, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        line = [ln for ln in cp.stdout.splitlines()
                if ln.startswith("CHILD:")]
        if cp.returncode != 0 or not line:
            table.append({"n_devices": n,
                          "error": (cp.stderr or cp.stdout)[-300:]})
            continue
        table.append(json.loads(line[-1][len("CHILD:"):]))
        print(json.dumps(table[-1]))
    out = {"host_cores": cores,
           "methodology": "strong scaling; an n-device child is "
                          "taskset-pinned to min(n, host_cores) cores, "
                          "so CPU resources scale with device count up "
                          "to the core count; rows with n_devices > "
                          "host_cores are oversubscribed (functional "
                          "evidence only)",
           "rows": table}
    timed = {r["n_devices"]: r for r in table
             if "p50_ms" in r and not r.get("oversubscribed")}
    if 1 in timed and cores in timed and cores > 1:
        out["strong_scaling_efficiency"] = round(
            timed[1]["p50_ms"] / (cores * timed[cores]["p50_ms"]), 3)
    return out


def main(argv=None):
    global MAX_ITER
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default="ladder.json")
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--max-iter", type=int, default=MAX_ITER,
                    help="iteration budget (500 = reference parity)")
    ap.add_argument("--device-scaling-child", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--skip-device-scaling", action="store_true",
                    help="skip the 1/2/4/8 virtual-CPU-mesh subprocess "
                         "sweep (slow; evidence-only)")
    ap.add_argument("--only", default=None,
                    help="run only rows whose config name contains this "
                         "substring and MERGE them into --out (other "
                         "rows/fields preserved); implies "
                         "--skip-device-scaling")
    args = ap.parse_args(argv)
    MAX_ITER = args.max_iter
    if args.device_scaling_child is not None:
        _device_scaling_child(args.device_scaling_child, MAX_ITER)
        return 0
    from rapidnet_jax.utils import platform
    if args.platform:
        platform.use_platform(args.platform)
    platform.enable_compile_cache()
    rep = args.repeats
    results = {"device": platform.device_summary()}
    rows = []
    only = args.only

    def want(name):
        return only is None or only in name

    # 1: deterministic toy, CPU path mandated by BASELINE
    name1 = ("1_toy_deterministic_H8_cpu"
             if results["device"]["platform"] == "cpu"
             else "1_toy_deterministic_H8")
    if want(name1):
        rows.append(run_config(name1, (3, 6, 4, 2), 8, [1], rep,
                               tune=False)[0])
    # 2: small binary tree, H=12
    if want("2_binary_tree_H12"):
        rows.append(run_config("2_binary_tree_H12", (3, 6, 4, 2), 12,
                               [2], rep, tune=False)[0])
    # 3: Barcelona-subset, ~100-node tree, H=24
    if want("3_barcelona_subset_100node_H24"):
        rows.append(run_config("3_barcelona_subset_100node_H24",
                               (20, 35, 25, 5), 24, [4], rep)[0])
    # 3R: REAL Barcelona-scale data (controllerConfig32.json +
    # scenarioTree32.json; real cost/preconditioner/penalties/tree,
    # synthetic topology — see _build_real)
    if want("3R_barcelona_REAL_136node_H24"):
        try:
            from rapidnet_jax.io import datasource
            if datasource.available():
                rows.append(run_config(
                    "3R_barcelona_REAL_136node_H24", None, 24, None,
                    rep, problem=_build_real(),
                    data="real tree/costs/precnd/state; "
                         "synthetic topology")[0])
        except Exception as exc:  # noqa: BLE001
            rows.append({"config": "3R_barcelona_REAL_136node_H24",
                         "error": str(exc)[:300]})
    # 4: Barcelona-scale, 556-node tree — single and batched
    r4 = prob4 = None
    if want("4_barcelona_556node_H24"):
        r4, prob4 = run_config("4_barcelona_556node_H24",
                               (63, 114, 88, 17), 24, [5, 5], rep)
        rows.append(r4)
    if want("4_barcelona_556node_H24_batch16"):
        rows.append(run_config("4_barcelona_556node_H24_batch16",
                               (63, 114, 88, 17), 24, [5, 5], rep,
                               batch=16, problem=prob4)[0])
    # 5: 1024-scenario tree (one build reused across the variants)
    rep5 = max(2, rep // 2)
    r5 = prob5 = None

    def get_prob5():
        nonlocal prob5
        if prob5 is None:
            prob5 = _build(*CONFIG5["dims"], CONFIG5["N"],
                           CONFIG5["branching"], max_iter=MAX_ITER)
        return prob5

    if want("5_1024scenario_H24"):
        r5, prob5 = run_config("5_1024scenario_H24", *_cfg5_args(),
                               rep5)
        rows.append(r5)
    # 5b: same solve through shard_map on a 1-device mesh
    # (quantifies shard_map overhead on one device)
    if want("5_1024scenario_H24_shardmap_1dev"):
        try:
            rows.append(sharded_overhead_row(get_prob5(), rep5))
        except Exception as exc:  # noqa: BLE001
            rows.append({"config": "5_1024scenario_H24_shardmap_1dev",
                         "error": str(exc)[:300]})
    # scenario-weak-scaling efficiency: per-scenario solve rate at
    # ns=1024 vs ns=25 (config 4) on the same device
    if r4 is not None and r5 is not None:
        eff = ((r5["scenarios"] / r5["p50_ms"]) /
               (r4["scenarios"] / r4["p50_ms"]))
        results["weak_scaling_1024_vs_25_scenarios"] = round(float(eff), 3)
    ladder_regression_check(rows, args.out, results["device"])
    if only is not None:
        # merge mode: update/append only the measured rows, preserve
        # everything else (incl. device_scaling) from the existing file
        try:
            with open(args.out) as f:
                prev = json.load(f)
        except Exception:  # noqa: BLE001
            prev = {"rows": []}
        by_cfg = {r.get("config"): i
                  for i, r in enumerate(prev.get("rows", []))}
        merged = 0
        for r in rows:
            i = by_cfg.get(r.get("config"))
            if "error" in r and i is not None and \
                    "p50_ms" in prev["rows"][i]:
                # never clobber a measured row with an error/skip row
                print(f"[ladder] keeping measured {r['config']} over "
                      f"error row: {r['error'][:80]}", file=sys.stderr)
                continue
            # merged rows were measured on THIS run's device; the
            # file-level metadata stays the original run's, so stamp
            # each row with its own
            if "p50_ms" in r:
                r["device"] = results["device"]
            if i is not None:
                prev["rows"][i] = r
            else:
                prev["rows"].append(r)
            merged += 1
        # preserve ALL original file-level metadata (device,
        # device_scaling): most rows still come from the original run —
        # per-row stamps above carry this run's
        with open(args.out, "w") as f:
            json.dump(prev, f, indent=1)
        print(json.dumps({"ladder": "merged", "rows": merged}))
        return 0
    results["rows"] = rows
    if not args.skip_device_scaling:
        results["device_scaling"] = device_scaling_table()
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"ladder": "done",
                      "weak_scaling_eff": results.get(
                          "weak_scaling_1024_vs_25_scenarios")}))
    return 0


def _cfg5_args():
    return (CONFIG5["dims"], CONFIG5["N"], CONFIG5["branching"])


def ladder_regression_check(new_rows, out_path, device):
    """Tripwire: flag >5% p50 slowdowns per config row vs the previous
    result file, when that file was measured on the same device.
    Informational, stderr only."""
    try:
        with open(out_path) as f:
            prev_file = json.load(f)
    except (OSError, ValueError):
        return
    if prev_file.get("device") != device:
        return
    prev = {r.get("config"): r for r in prev_file.get("rows", [])}
    for r in new_rows:
        old = prev.get(r.get("config"))
        if not old or "p50_ms" not in r or "p50_ms" not in old:
            continue
        delta = (r["p50_ms"] - old["p50_ms"]) / old["p50_ms"]
        flag = "  ** REGRESSION >5% **" if delta > 0.05 else ""
        print(f"[ladder] {r['config']}: p50 {old['p50_ms']:.1f} -> "
              f"{r['p50_ms']:.1f} ms ({delta * 100:+.1f}%){flag}",
              file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
