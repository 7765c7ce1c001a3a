"""Warm-start study: closed-loop quality vs iteration budget, warm vs
cold, the measurement behind solver/apg.py's warm-start note.

The receding-horizon deployment question: with the previous solve's
duals as the next solve's starting point, how small can the iteration
budget get before the closed-loop control trajectory departs from the
full-budget (cold-500) answer?  Protocol, on the bench problem
(556-node tree, tuned preconditioner):

* reference trajectory: cold starts at the reference budget (500,
  the budget the reference hard-codes — testDataFiles/
  controllerConfig.json).
* for each reduced budget B: run the same closed loop cold-B and
  warm-B; report the max relative control deviation from the
  reference trajectory across all steps.

Prints one JSON row per run and a markdown table.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--budgets", default="100,200,300")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--ref-budget", type=int, default=500)
    args = ap.parse_args()

    import jax

    from bench import build_problem
    from rapidnet_jax.engine.engine import XS_UPPER
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.solver import apg as apg_mod

    cfg, eng, fa, make_step, tree = build_problem()
    base_kw = dict(inv_step=1.0 / cfg.step_size,
                   step_size=cfg.step_size,
                   penalty_state=cfg.penalty_state,
                   penalty_safety=cfg.penalty_safety,
                   xs_upper=float(XS_UPPER))
    prefix = eng.factor_step().prefix_stages

    # realised demand for the built-in simulator: the bench
    # forecaster's t=0 nominal row (same every step — the study varies
    # the solver, not the scenario realisation)
    fc = synthetic_forecaster(N=24, nd=88, nu=114, sim_horizon=4,
                              seed=42)
    fc.predict_demand(0)
    d0 = fc.nominal_demand[0].astype(np.float32)
    B_mat = eng.network.matB
    Gd = eng.network.matGd

    def loop(budget, warm):
        run = jax.jit(apg_mod.make_apg(
            prefix_stages=prefix, max_iterations=int(budget),
            **base_kw))
        x = cfg.current_x.copy()
        y = None
        controls = []
        for _ in range(args.steps):
            step = make_step(x)
            out = (run(fa, step, y) if (warm and y is not None)
                   else run(fa, step))
            u = np.asarray(out["control"])
            if warm:
                y = jax.tree.map(np.asarray, out["y"])
            controls.append(u)
            x = (x + B_mat @ u + Gd @ d0).astype(np.float32)
        return np.asarray(controls)

    ref_controls = loop(args.ref_budget, warm=False)
    uscale = max(np.abs(ref_controls).max(), 1e-9)
    rows = []

    def record(budget, warm):
        ctr = loop(budget, warm)
        dev = float(np.abs(ctr - ref_controls).max() / uscale)
        rows.append({"budget": int(budget), "warm": bool(warm),
                     "max_ctrl_rel_dev_vs_cold500": round(dev, 5)})
        print(json.dumps(rows[-1]), flush=True)

    for b in [int(x) for x in args.budgets.split(",")]:
        record(b, False)
        record(b, True)
    record(args.ref_budget, True)   # full budget warm: same answer?

    print("\n| budget | cold max dev | warm max dev |")
    print("|---|---|---|")
    by = {}
    for r in rows:
        by.setdefault(r["budget"], {})[r["warm"]] = \
            r["max_ctrl_rel_dev_vs_cold500"]
    for b, d in sorted(by.items()):
        cold = f"{d[False]:.2%}" if False in d else "(reference)"
        warmv = f"{d[True]:.2%}" if True in d else "-"
        print(f"| {b} | {cold} | {warmv} |")
    print(json.dumps({"summary": True, "steps": args.steps,
                      "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
