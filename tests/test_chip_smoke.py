"""chip_smoke.py's pure pieces, and its phases at a tiny size on the CPU.

The script itself refuses anything but a GPU; here its phase functions
take the CPU device explicitly, so the same code that runs on the card
is exercised end to end at a toy scale.
"""

import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SMALL4 = dict(nx=4, nu=7, nd=3, ne=2, N=6, branching=(2, 2))
SMALL5 = dict(SMALL4, branching=(4, 2))
TINY = dict(iterations=20, short_iterations=5, ensemble=2)


def _device(platform):
    return types.SimpleNamespace(platform=platform, device_kind="fake")


@pytest.mark.parametrize("platform", ["cpu", "metal", "rocm"])
def test_refuses_non_gpu_device(platform):
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.require_gpu(_device(platform))


def test_accepts_gpu_device():
    cs.require_gpu(_device("gpu"))


@pytest.mark.parametrize("four_cards,phases", [
    (False, ["device", "closed_loop", "card_vs_cpu", "batched",
             "large_tree"]),
    (True, ["device", "four_cards"]),
])
def test_phase_selection(four_cards, phases):
    assert cs.phases_for(four_cards) == phases


def test_max_rel_dev_scales_by_reference_or_one():
    assert cs.max_rel_dev([2.0, 0.0], [1.0, 0.0]) == pytest.approx(1.0)
    assert cs.max_rel_dev([10.1, 0.0], [10.0, 0.0]) == pytest.approx(0.01)
    # small references are measured against 1, not blown up
    assert cs.max_rel_dev([1e-3], [1e-6]) == pytest.approx(1e-3 - 1e-6)


def test_checks_record_and_fail():
    ok = cs.Checks("ok")
    assert "FAILED" not in ok.bound("x", 1e-4, 1e-3)
    assert "FAILED" not in ok.dev("u", [1.0, 2.0], [1.0, 2.0], 1e-6)
    assert "FAILED" not in ok.close("c", [1.0], [1.0 + 1e-7],
                                    rtol=1e-6, atol=0.0)
    ok.done()

    bad = cs.Checks("bad")
    assert bad.bound("x", 2e-3, 1e-3).endswith("FAILED")
    assert bad.dev("u", [np.nan], [1.0], 1.0).endswith("FAILED")
    assert bad.close("c", [1.0], [1.1], rtol=1e-2, atol=0.0).endswith(
        "FAILED")
    with pytest.raises(cs.SmokeFailure, match="bad"):
        bad.done()


def test_checks_exceeds_is_a_control():
    c = cs.Checks("control")
    assert "FAILED" not in c.exceeds("tf32", 3e-3, 1e-4)
    assert c.exceeds("tf32", 1e-6, 1e-4).endswith("FAILED")
    with pytest.raises(cs.SmokeFailure, match="must exceed"):
        c.done()


def test_spread_is_the_largest_pairwise_deviation():
    runs = [np.zeros(3), np.array([0.0, 0.002, 0.0]),
            np.array([0.0, -0.003, 0.0])]
    assert cs.spread(runs) == pytest.approx(0.005)
    assert cs.spread(runs[:1]) == 0.0


@pytest.mark.parametrize("algo,refs,bound", [
    # APG: TIGHT_RTOL whatever the references
    (cs.APG, [np.zeros(2), np.ones(2)], cs.TIGHT_RTOL),
    # FBE/NAMA: SPREAD_FACTOR x the reference's own spread ...
    (cs.NAMA, [np.zeros(2), np.array([0.004, 0.0])],
     cs.SPREAD_FACTOR * 0.004),
    # ... never below TIGHT_RTOL (a reference that did not fork)
    (cs.FBE, [np.zeros(2), np.zeros(2)], cs.TIGHT_RTOL),
])
def test_full_bound(algo, refs, bound):
    got, how = cs.full_bound(algo, refs)
    assert got == pytest.approx(bound)
    assert ("spread" in how) == (algo != cs.APG)


def test_perturbed_moves_by_about_one_rounding():
    x = np.linspace(1.0, 100.0, 50, dtype=np.float32)
    a, b = cs.perturbed(x, 1), cs.perturbed(x, 2)
    assert a.dtype == np.float32
    rel = np.abs(a.astype(np.float64) / x - 1.0)
    assert 0 < rel.max() <= 2e-6
    np.testing.assert_array_equal(a, cs.perturbed(x, 1))
    assert not np.array_equal(a, b)
    step = {"x0": x, "beta": np.ones(3, np.float32)}
    moved = cs.perturbed(step, 1)
    np.testing.assert_array_equal(np.asarray(moved["x0"]), a)
    assert moved["beta"] is step["beta"]


def test_matmul_precision_reaches_the_traced_solve():
    """The control's override changes the precision of every solve-path
    matmul in the lowered program, and is undone afterwards."""
    from jax import lax

    from rapidnet_jax.solver import solve_step

    p = cs.build_problem(SMALL4)

    def lowered():
        ctrl = p.controller(cs.APG, 2)
        ctrl.initialise()
        return ctrl._solver.lower(ctrl._fa, ctrl.prepare_step(0),
                                  None).as_text()

    assert "HIGHEST" in lowered()
    with cs.matmul_precision(lax.Precision.DEFAULT):
        assert "HIGHEST" not in lowered()
    assert solve_step.MM_PRECISION == lax.Precision.HIGHEST
    assert "HIGHEST" in lowered()


def test_script_fails_without_gpu():
    """On a machine with no GPU the script exits non-zero and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cp = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                        capture_output=True, text=True, timeout=300,
                        env=env, cwd=ROOT)
    assert cp.returncode != 0
    assert '"ok"' not in cp.stdout
    assert "no GPU" in cp.stdout


def test_script_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    cp = subprocess.run([sys.executable, str(script)], capture_output=True,
                        text=True, timeout=300, env=env, cwd=tmp_path)
    assert cp.returncode != 0
    assert '"ok"' not in cp.stdout


def test_default_phases_at_toy_size(capsys):
    cpu = jax.devices("cpu")[0]
    # the Precision.DEFAULT control needs the card's TF32: on the CPU
    # DEFAULT is f32 and matches (test_matmul_precision_... covers it)
    cs.run(False, device=cpu, cpu=cpu, dims4=SMALL4, dims5=SMALL5,
           steps=2, batch=3, precision_control=False, **TINY)
    out = capsys.readouterr().out
    for tag in ("phase 2", "phase 3", "phase 4", "phase 5"):
        assert f"{tag} wall_s=" in out
    assert "FAILED" not in out
    assert out.count("path=xla ") == 5


def test_four_card_phase_on_virtual_devices(capsys):
    devices = jax.devices("cpu")
    assert len(devices) >= 4
    cs.run(True, device=devices[0], cpu=devices[0], dims5=SMALL5,
           devices=devices, **TINY)
    out = capsys.readouterr().out
    assert "phase 6 wall_s=" in out
    assert "path=xla+shard_map" in out
    assert "2-D (batch 2, scen 2) mesh" in out
    assert "FAILED" not in out
