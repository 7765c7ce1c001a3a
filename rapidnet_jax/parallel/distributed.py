"""Multi-host initialisation and mesh construction.

The reference has no distributed story at all (one process, one GPU,
one cublasHandle_t — src/Engine.cuh:673).  For multi-host scale-out
the framework uses the standard JAX multi-controller model:

* every host calls :func:`initialize` (jax.distributed) once;
* :func:`scenario_mesh` builds a 1-D mesh over *all* devices of all
  processes — scenario blocks are contiguous per device, so the tree
  tail never crosses hosts and only the branching-prefix psums and the
  scalar psums cross the interconnect;
* the per-host data feed shards the scenario axis with
  ``jax.make_array_from_process_local_data`` so each host only
  materialises its own scenarios.

On a single host these helpers degrade to the local device mesh, so the
same driver script runs everywhere.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rapidnet_jax.parallel.sharding import AXIS


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize (no-op single-process, or if the
    runtime is already initialised).  Nothing discovers a GPU cluster:
    pass the coordinator address, process count and process id."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except RuntimeError:
        pass  # already initialised


def scenario_mesh() -> Mesh:
    """1-D scenario mesh over every device of every process."""
    return Mesh(np.asarray(jax.devices()), (AXIS,))


def host_local_scenario_slice(total_ns: int) -> slice:
    """The contiguous scenario block this host owns."""
    n_proc = jax.process_count()
    pid = jax.process_index()
    if total_ns % n_proc:
        raise ValueError(f"ns={total_ns} not divisible by "
                         f"{n_proc} processes")
    per = total_ns // n_proc
    return slice(pid * per, (pid + 1) * per)


def make_global_fan_array(mesh: Mesh, host_local, *, sharded_dim=1):
    """Assemble a globally-sharded (N, ns, d) array from the host-local
    scenario block (multi-host data feed)."""
    spec = [None] * host_local.ndim
    spec[sharded_dim] = AXIS
    sharding = NamedSharding(mesh, P(*spec))
    if jax.process_count() == 1:
        return jax.device_put(host_local, sharding)
    return jax.make_array_from_process_local_data(sharding, host_local)


def _make_global(mesh: Mesh, spec: P, global_np):
    """Globally-sharded array from a full copy of the global data.

    Every host holds the (small, host-side) global numpy arrays; this
    carves out exactly the shards owned by this process's devices and
    assembles the jax.Array across processes.  Works for ANY partition
    spec — 1-D scenario meshes and the 2-D (batch, scen) mesh
    alike (each addressable device receives its own index block, so no
    per-axis process-contiguity assumption is needed).  Single-process:
    a plain device_put.
    """
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(global_np, sharding)
    global_np = np.asarray(global_np)
    idx_map = sharding.addressable_devices_indices_map(global_np.shape)
    shards = [jax.device_put(np.ascontiguousarray(global_np[idx]), d)
              for d, idx in idx_map.items()]
    return jax.make_array_from_single_device_arrays(
        global_np.shape, sharding, shards)


def shard_problem_multihost(mesh: Mesh, fa: dict, step: dict):
    """Assemble globally-sharded factor/step dicts on a multi-process
    mesh, each process contributing only its scenario block.

    The sharding layout matches :func:`rapidnet_jax.parallel.sharding.
    shard_factor_arrays` / ``shard_step_arrays`` (which are the
    single-process fast path), so the result feeds ``make_sharded_apg``
    unchanged on a mesh that spans processes.
    """
    from rapidnet_jax.parallel.sharding import _fa_specs, _step_specs

    fa_specs, step_specs = _fa_specs(fa), _step_specs(step)
    put = lambda x, s: _make_global(mesh, s, np.asarray(x))
    fa_sh = jax.tree.map(put, fa, fa_specs,
                         is_leaf=lambda x: not isinstance(x, dict))
    step_sh = jax.tree.map(put, step, step_specs)
    return fa_sh, step_sh
