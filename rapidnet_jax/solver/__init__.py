from rapidnet_jax.solver.batch import BatchedSmpcController
from rapidnet_jax.solver.controller import SmpcController

__all__ = ["SmpcController", "BatchedSmpcController"]
