from rapidnet_jax.utils.timing import TicToc

__all__ = ["TicToc"]
