"""Closed-loop SMPC on the reference's golden fixture problem.

Mirrors the reference's product entry point (main.cu:34-69): build a
controller from the 4-file JSON config graph, then loop
forecast -> controlAction -> moveForwardInTime and report KPIs.

Run:
    python examples/closed_loop_reference_fixtures.py \
        [--config /root/reference/src/test/testDataFiles/controllerConfig.json]

Any reference-format controllerConfig.json works; the paths inside it
(pathToNetwork / pathToScenarioTree / pathToForecaster) are resolved
against the config file's directory.
"""

import argparse

DEFAULT = "/root/reference/src/test/testDataFiles/controllerConfig.json"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=DEFAULT)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    args = ap.parse_args()

    if args.platform:
        from rapidnet_jax.utils.platform import use_platform
        use_platform(args.platform)

    from rapidnet_jax import SmpcController

    ctrl = SmpcController(args.config)
    for t in range(args.steps):
        u = ctrl.control_action(t)          # one receding-horizon solve
        x_next = ctrl.move_forward_in_time()  # built-in simulator + KPIs
        print(f"t={t}  u0[:3]={u[:3]}  x+[:3]={x_next[:3]}  "
              f"solve={ctrl.solve_times_ms[-1]:.1f} ms")

    T = args.steps
    print(f"economic kpi {ctrl.economic_kpi(T):.4f}")
    print(f"smooth   kpi {ctrl.smooth_kpi(T):.4f}")
    print(f"safety   kpi {ctrl.safety_kpi(T):.4f}")
    print(f"network  kpi {ctrl.network_kpi(T):.4f}")


if __name__ == "__main__":
    main()
