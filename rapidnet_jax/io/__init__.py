from rapidnet_jax.io.jsonio import load_json, dump_json, scalar, vector, matrix_colmajor

__all__ = ["load_json", "dump_json", "scalar", "vector", "matrix_colmajor"]
