from rapidnet_jax.model.network import DwnNetwork
from rapidnet_jax.model.scenario_tree import ScenarioTree
from rapidnet_jax.model.forecaster import Forecaster
from rapidnet_jax.model.config import SmpcConfig

__all__ = ["DwnNetwork", "ScenarioTree", "Forecaster", "SmpcConfig"]
