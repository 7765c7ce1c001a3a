from rapidnet_jax.engine.engine import Engine, FactorData

__all__ = ["Engine", "FactorData"]
