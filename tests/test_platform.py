"""The one platform decision (utils/platform.py) and its callers."""

import os
import subprocess
import types

import jax
import pytest

from rapidnet_jax.utils import platform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_supported_platforms_accepted(name):
    assert platform.check_platform(name) == name


@pytest.mark.parametrize("name", ["metal", "cuda", "rocm", ""])
def test_other_platforms_raise(name):
    with pytest.raises(ValueError, match="unsupported platform"):
        platform.check_platform(name)


def test_use_platform_rejects_before_touching_jax(monkeypatch):
    calls = []
    monkeypatch.setattr(platform.jax.config, "update",
                        lambda *a: calls.append(a))
    with pytest.raises(ValueError):
        platform.use_platform("metal")
    platform.use_platform("gpu")
    platform.use_platform("cpu")
    # JAX's own name for the NVIDIA backend: "gpu" would also start ROCm
    assert calls == [("jax_platforms", "cuda"), ("jax_platforms", "cpu")]


def test_device_platform_checks_the_device():
    assert platform.device_platform() == "cpu"
    assert platform.device_platform(jax.devices("cpu")[0]) == "cpu"
    with pytest.raises(ValueError):
        platform.device_platform(types.SimpleNamespace(platform="metal"))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(platform.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(platform.jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert platform.enable_compile_cache() == path
    assert calls == [("jax_compilation_cache_dir", path)] * 2
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_nvidia_smi_absent_is_none(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(platform.subprocess, "run", missing)
    assert platform.nvidia_smi() is None

    def failing(*a, **k):
        return subprocess.CompletedProcess(a, 9, "", "no devices")
    monkeypatch.setattr(platform.subprocess, "run", failing)
    assert platform.nvidia_smi() is None


def test_nvidia_smi_line_passed_through(monkeypatch):
    line = "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(
        platform.subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a, 0, line + "\n", ""))
    assert platform.nvidia_smi() == line


def test_device_summary_names_the_device():
    summary = platform.device_summary()
    assert summary["platform"] == "cpu"
    assert summary["device_count"] == len(jax.devices())
    assert summary["device_kind"] == jax.devices()[0].device_kind
    assert set(summary) == {"platform", "device_kind", "device_count",
                            "gpu"}


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_cli_platform_parsing(name):
    from rapidnet_jax import cli
    args = cli.build_parser().parse_args(
        ["--config", "c.json", "--platform", name])
    assert args.platform == name


@pytest.mark.parametrize("argv", [["--platform", "metal"],
                                  ["--backend", "pallas"],
                                  ["--stream-precision", "default"]])
def test_cli_rejects_removed_options(argv):
    from rapidnet_jax import cli
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--config", "c.json", *argv])


@pytest.mark.parametrize("script", ["bench", "bench_ladder"])
def test_bench_platform_choices(script):
    import importlib
    mod = importlib.import_module(script)
    with pytest.raises(SystemExit):
        mod.main(["--platform", "metal"])


def _tiny_problem():
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.forecaster import synthetic_forecaster
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import generate_tree
    net = synthetic_network(nx=4, nu=7, nd=3, ne=2, seed=1)
    tree = generate_tree(N=4, branching=[2], nd=3, nu=7, seed=1)
    fc = synthetic_forecaster(N=4, nd=3, nu=7, sim_horizon=2, seed=1)
    cfg = synthetic_config(net, tree, max_iterations=5, step_size=1e-3)
    return cfg, net, tree, fc


@pytest.mark.parametrize("backend", ["pallas", "stream"])
@pytest.mark.parametrize("batched", [False, True])
def test_controllers_reject_removed_backends(backend, batched):
    """The XLA solve is the only path: no ``backend`` option remains."""
    from rapidnet_jax.solver.batch import BatchedSmpcController
    from rapidnet_jax.solver.controller import SmpcController
    cfg, net, tree, fc = _tiny_problem()
    with pytest.raises(TypeError, match="backend"):
        if batched:
            BatchedSmpcController(cfg, net, tree, fc,
                                  cfg.current_x[None], backend=backend)
        else:
            SmpcController(cfg, network=net, tree=tree, forecaster=fc,
                           backend=backend)


@pytest.mark.parametrize("batched", [False, True])
def test_controllers_refuse_unsupported_platform(batched, monkeypatch):
    from rapidnet_jax.solver.batch import BatchedSmpcController
    from rapidnet_jax.solver.controller import SmpcController
    cfg, net, tree, fc = _tiny_problem()
    if batched:
        ctrl = BatchedSmpcController(cfg, net, tree, fc,
                                     cfg.current_x[None])
    else:
        ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc)
    fake = types.SimpleNamespace(platform="metal", device_kind="fake")
    monkeypatch.setattr(platform.jax, "devices", lambda *a: [fake])
    with pytest.raises(ValueError, match="unsupported platform 'metal'"):
        ctrl.initialise()


def test_controller_reports_xla_path():
    from rapidnet_jax.solver.controller import SmpcController
    cfg, net, tree, fc = _tiny_problem()
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc)
    assert ctrl.solver_path is None
    ctrl.initialise()
    assert ctrl.solver_path == "xla"
