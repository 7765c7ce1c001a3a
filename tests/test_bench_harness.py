"""The benchmark harnesses stay runnable (CPU, tiny budgets).

bench.py and bench_ladder.py are the device measurement scripts; these
smoke tests keep them from rotting between GPU runs.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_ladder_smoke(tmp_path):
    out = tmp_path / "ladder.json"
    cp = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_ladder.py"),
         "--platform", "cpu", "--max-iter", "5", "--repeats", "1",
         "--skip-device-scaling", "--out", str(out)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert cp.returncode == 0, cp.stderr[-2000:]
    data = json.loads(out.read_text())
    names = [r["config"] for r in data["rows"]]
    assert any("1_toy" in n for n in names)
    assert any("5_1024scenario" in n for n in names)
    # every row is measured on the XLA path, and the file names the
    # device it ran on
    assert data["device"]["platform"] == "cpu"
    assert data["device"]["device_count"] >= 1
    for r in data["rows"]:
        assert r.get("solves_per_s", 0) > 0, r
        assert r["path"] in ("xla", "xla+shard_map"), r
    assert {"1_toy_deterministic_H8_cpu", "2_binary_tree_H12",
            "3_barcelona_subset_100node_H24", "4_barcelona_556node_H24",
            "4_barcelona_556node_H24_batch16", "5_1024scenario_H24",
            "5_1024scenario_H24_shardmap_1dev"} <= set(names)


def test_bench_measure_smoke(monkeypatch):
    """bench.measure() runs on CPU with a reduced budget and returns
    the full metric dict (single + batched)."""
    import bench as B
    monkeypatch.setattr(B, "MAX_ITER", 5)
    monkeypatch.setattr(B, "BATCH", 2)
    res = B.measure(repeats=1)
    assert res["solves_per_s"] > 0
    assert res["batch_solves_per_s"] > 0
    assert res["tree_nodes"] == 556
    assert np.isfinite(res["final_infeasibility"])
    # one bench line per algorithm (reference dispatch parity,
    # src/SmpcController.cu:63-71)
    assert set(res["algo_solves_per_s"]) == {"apg", "fbe", "nama"}
    assert all(v > 0 for v in res["algo_solves_per_s"].values())
    # time-to-solution diagnostics: per-algorithm budget wall ms always
    # present; stabilisation fields may be null (an algorithm whose
    # control never stabilises at the anchor within the budget ladder)
    tts = res["time_to_solution"]
    for algo in ("apg", "fbe", "nama"):
        assert tts[algo]["cold_budget_ms"] > 0
        assert "cold_iters" in tts[algo] and "warm_iters" in tts[algo]


def test_ladder_only_merge_mode(tmp_path):
    """--only measures a row subset and merges into the existing out
    file: other rows/fields preserved, measured rows never clobbered
    by error rows, merged rows stamped with their own device."""
    out = tmp_path / "ladder.json"
    prev = {
        "device": {"platform": "gpu", "device_kind": "fake",
                   "device_count": 1, "gpu": "fake, 1.00 W"},
        "rows": [
            {"config": "5_1024scenario_H24", "p50_ms": 274.9,
             "solves_per_s": 3.64, "batch": 1},
            {"config": "2_binary_tree_H12", "p50_ms": 28.6,
             "solves_per_s": 34.9, "batch": 1},
        ],
        "device_scaling": {"rows": []},
    }
    out.write_text(json.dumps(prev))
    cp = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench_ladder.py"),
         "--platform", "cpu", "--max-iter", "5", "--repeats", "1",
         "--only", "2_binary", "--out", str(out)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert cp.returncode == 0, cp.stderr[-2000:]
    data = json.loads(out.read_text())
    by_cfg = {r["config"]: r for r in data["rows"]}
    # untouched row + file-level fields preserved
    assert by_cfg["5_1024scenario_H24"]["p50_ms"] == 274.9
    assert data["device"] == prev["device"]
    assert "device_scaling" in data
    # merged row re-measured (tiny CPU budget -> much faster than the
    # fake 28.6 ms) and stamped with the device it ran on
    row = by_cfg["2_binary_tree_H12"]
    assert row["p50_ms"] != 28.6
    assert row["device"]["platform"] == "cpu"
