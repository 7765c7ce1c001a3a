"""Test config: CPU backend with a virtual 8-device mesh.

Mirrors the SURVEY §4 recommendation: golden-fixture tests run on the
CPU jit path so CI needs no accelerator; multi-device sharding tests use
xla_force_host_platform_device_count.

Tests marked ``gpu`` need an NVIDIA GPU.  They decide inside the
``gpu_device`` fixture whether one is present (never at import, so every
pytest-xdist worker collects the same tests) and skip without one.  Run
them on a GPU machine with ``RAPIDNET_GPU_TESTS=1 pytest -m gpu``.
"""

import os

GPU_TIER = os.environ.get("RAPIDNET_GPU_TESTS") == "1"

if not GPU_TIER:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import numpy as np
import pytest

REFERENCE_FIXTURES = "/root/reference/src/test/testDataFiles"
REFERENCE_DATA = "/root/reference/src/dataFiles"


def fixture_path(name: str) -> str:
    return os.path.join(REFERENCE_FIXTURES, name)


requires_reference = pytest.mark.skipif(
    not os.path.isdir(REFERENCE_FIXTURES),
    reason="reference fixture files not available")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (RAPIDNET_GPU_TESTS=1 on a GPU "
                    "machine)")
    return gpus[0]


@pytest.fixture(scope="session")
def ref_problem():
    """The 3-tank / K=6 / N=24 golden test problem of the reference."""
    if not os.path.isdir(REFERENCE_FIXTURES):
        pytest.skip("reference fixtures not available")
    from rapidnet_jax.model.config import SmpcConfig
    from rapidnet_jax.model.network import DwnNetwork
    from rapidnet_jax.model.scenario_tree import ScenarioTree
    from rapidnet_jax.model.forecaster import JsonForecaster

    config = SmpcConfig.from_json(fixture_path("controllerConfig.json"))
    network = DwnNetwork.from_json(fixture_path("network.json"))
    tree = ScenarioTree.from_json(fixture_path("scenarioTree.json"))
    forecaster = JsonForecaster(fixture_path("forecastor.json"))
    return dict(config=config, network=network, tree=tree,
                forecaster=forecaster)


@pytest.fixture(scope="session")
def ref_engine(ref_problem):
    from rapidnet_jax.engine.engine import Engine
    eng = Engine(ref_problem["network"], ref_problem["tree"],
                 ref_problem["config"])
    eng.factor_step()
    return eng
