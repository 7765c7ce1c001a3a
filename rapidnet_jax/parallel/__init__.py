from rapidnet_jax.parallel.sharding import (make_mesh, make_mesh_2d,
                                            make_sharded_apg,
                                            make_sharded_apg_batch,
                                            make_sharded_batch_shared,
                                            make_sharded_qn_batch,
                                            make_sharded_quasi_newton,
                                            shard_dual_arrays,
                                            shard_factor_arrays,
                                            shard_shared_step,
                                            shard_step_arrays,
                                            shard_step_arrays_batch)

__all__ = ["make_mesh", "make_mesh_2d", "make_sharded_apg",
           "make_sharded_apg_batch", "make_sharded_batch_shared",
           "make_sharded_qn_batch", "make_sharded_quasi_newton",
           "shard_dual_arrays", "shard_factor_arrays",
           "shard_shared_step", "shard_step_arrays",
           "shard_step_arrays_batch"]
