"""Multi-chip scale-out: scenario-axis sharding of the SMPC solve.

The reference is strictly single-GPU (one cublasHandle_t,
src/Engine.cuh:673; no NCCL/MPI anywhere).  Here the scenario/subtree
axis — the fan-layout slot axis — is sharded over a
``jax.sharding.Mesh``:

* the non-branching tail of both tree sweeps is embarrassingly parallel
  per scenario (each device owns a contiguous block of scenarios —
  contiguity is guaranteed by the fan-layout construction, so subtree
  edges never cross shards in the tail);
* only the branching-prefix child->parent reductions cross shards: the
  aggregation sums each shard's distinct-parent block with one ``psum``
  per prefix stage (a few kB);
* the global penalty norms of prox-g and the infeasibility diagnostic
  are ``psum``/``all_gather`` scalars.

This matches the "shard the scenario axis, keep the stage sweep local"
strategy of SURVEY.md §2/§5.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from rapidnet_jax.solver import apg as apg_mod

AXIS = "scen"
BATCH_AXIS = "batch"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"requested a {n_devices}-device mesh but only "
                    f"{len(devices)} devices are visible "
                    f"({devices[0].platform}); pass devices= explicitly "
                    "(e.g. jax.devices('cpu') under "
                    "--xla_force_host_platform_device_count)")
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def _fa_specs(fa: dict) -> dict:
    """PartitionSpecs for the factor-array dict (slot axis = AXIS)."""
    specs = {}
    for k, v in fa.items():
        if k == "prefix_C":
            specs[k] = {s: P(AXIS, None) for s in v}
        elif k == "prefix_Cp":
            # child-sum operators: columns = slot axis (sharded); the
            # (Rp, d) parent block they produce is psum'd across shards
            specs[k] = {s: P(None, AXIS) for s in v}
        elif k == "prefix_Bp":
            specs[k] = {s: P(AXIS, None) for s in v}
        elif k == "rep":
            specs[k] = P(None, AXIS)
        elif hasattr(v, "ndim") and v.ndim == 3:
            specs[k] = P(None, AXIS, None)   # (N, ns, d)
        else:
            specs[k] = P()                   # shared small matrices
    return specs


def _step_specs(step: dict) -> dict:
    specs = {}
    for k, v in step.items():
        if hasattr(v, "ndim") and v.ndim == 3:
            specs[k] = P(None, AXIS, None)
        else:
            specs[k] = P()                   # x0 / prev_u / prev_uhat
    return specs


def _put(x, spec, mesh: Mesh):
    """Stage one array onto the mesh.

    Single process: plain ``device_put``.  Multi-process mesh:
    cross-process assembly via the multihost data feed — every
    process passes the identical global host array (the controller's
    ``prepare_step`` is host-side and deterministic, so all hosts
    compute the same step dict) and contributes exactly the shards its
    devices own (``distributed._make_global``).  Handles both the 1-D
    scenario mesh and the 2-D (batch, scen) mesh.
    """
    if jax.process_count() == 1:
        return jax.device_put(x, NamedSharding(mesh, spec))
    from rapidnet_jax.parallel.distributed import _make_global
    return _make_global(mesh, spec, np.asarray(x))


def shard_factor_arrays(fa: dict, mesh: Mesh) -> dict:
    specs = _fa_specs(fa)
    return jax.tree.map(
        lambda x, s: _put(x, s, mesh), fa, specs,
        is_leaf=lambda x: not isinstance(x, dict))


def shard_step_arrays(step: dict, mesh: Mesh) -> dict:
    specs = _step_specs(step)
    return jax.tree.map(lambda x, s: _put(x, s, mesh), step, specs)


def shard_dual_arrays(y: dict, mesh: Mesh, batched: bool = False) -> dict:
    """Place a dual warm-start pair {xi, psi} onto the mesh (solver
    outputs already carry this sharding; use for host-built zeros or
    checkpoint-restored carries).  ``batched``: leading batch axis
    sharded over BATCH_AXIS (2-D mesh, single-process staging only)."""
    spec = (P(BATCH_AXIS, None, AXIS, None) if batched
            else P(None, AXIS, None))
    return {k: _put(jnp.asarray(y[k]), spec, mesh)
            for k in ("xi", "psi")}



def _broadcast_root_control(out: dict, fa: dict) -> dict:
    """Stage-0 control lives in slot 0 (the scenario-axis-0 owner's
    shard); project onto the PHYSICAL control bounds and broadcast
    (src/SmpcController.cu:1647-1649; see solve_step.
    root_control_bounds for the deliberate bounds deviation)."""
    from rapidnet_jax.solver.solve_step import root_control_bounds
    lo, hi = root_control_bounds(fa)
    u0 = jnp.clip(out["u"][0, 0], lo, hi)
    idx = lax.axis_index(AXIS)
    u0 = jnp.where(idx == 0, u0, jnp.zeros_like(u0))
    out["control"] = lax.psum(u0, AXIS)
    return out


def _base_out_specs() -> dict:
    """out_specs shared by every sharded solver (scenario axis = AXIS;
    'control' and the diagnostics replicated)."""
    return {
        "control": P(),        # computed on the slot-0 owner, broadcast
        "x": P(None, AXIS, None),
        "u": P(None, AXIS, None),
        "v": P(None, AXIS, None),
        "y": {"xi": P(None, AXIS, None), "psi": P(None, AXIS, None)},
        "primal_infeasibility": P(),
    }


def _y_specs() -> dict:
    return {"xi": P(None, AXIS, None), "psi": P(None, AXIS, None)}


def _wrap_optional_y0(jfn, fa_template: dict, step_template: dict,
                      batch: int | None = None):
    """fn(fa, step, y0=None): shard_map signatures are fixed, so a cold
    start substitutes host zeros (jit reshards them onto the mesh)."""
    N, ns, nx = (np.asarray(fa_template["d1"]).shape)
    nu = np.asarray(fa_template["g"]).shape[-1]
    shape = (N, ns) if batch is None else (batch, N, ns)
    zeros = {"xi": np.zeros(shape + (2 * nx,), np.float32),
             "psi": np.zeros(shape + (nu,), np.float32)}

    def run(fa, step, y0=None):
        return jfn(fa, step, zeros if y0 is None else y0)

    return run


def _wrap_optional_y0_batch(jfn, fa_template: dict):
    """Batched variant: the batch size is read off the steps argument."""
    N, ns, nx = np.asarray(fa_template["d1"]).shape
    nu = np.asarray(fa_template["g"]).shape[-1]

    def run(fa, steps, y0=None):
        if y0 is None:
            B = np.asarray(steps["beta"].shape)[0]
            y0 = {"xi": np.zeros((B, N, ns, 2 * nx), np.float32),
                  "psi": np.zeros((B, N, ns, nu), np.float32)}
        return jfn(fa, steps, y0)

    return run


def make_sharded_apg(mesh: Mesh, fa_template: dict, step_template: dict, *,
                     prefix_stages: tuple, inv_step: float, step_size: float,
                     penalty_state: float, penalty_safety: float,
                     xs_upper: float, max_iterations: int,
                     tolerance: float | None = None):
    """Jitted multi-device APG solve via shard_map over the scenario axis.

    Returns fn(fa, step, y0) -> outputs where x/u/v/duals keep the
    scenario sharding; 'control' (stage-0 node's u, projected onto its
    bounds) and the infeasibility trace are replicated scalars/vectors.
    ``y0`` is the dual warm start (pass zeros to cold-start; the
    shard_map signature is fixed).  ``tolerance`` enables early
    termination — the infeasibility diagnostic is already replicated
    (all_gather inside signed_max_abs), so every shard exits the
    while_loop on the same iteration.
    """
    run_core = apg_mod.make_apg(
        prefix_stages=prefix_stages, inv_step=inv_step, step_size=step_size,
        penalty_state=penalty_state, penalty_safety=penalty_safety,
        xs_upper=xs_upper, max_iterations=max_iterations,
        axis_name=AXIS, project_control=False, tolerance=tolerance)

    in_specs = (_fa_specs(fa_template), _step_specs(step_template),
                _y_specs())
    out_specs = dict(_base_out_specs(), iterations=P())

    def body(fa, step, y0):
        return _broadcast_root_control(run_core(fa, step, y0), fa)

    fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return _wrap_optional_y0(jax.jit(fn), fa_template, step_template)


def make_mesh_2d(n_batch: int, n_scen: int, devices=None) -> Mesh:
    """2-D mesh: batch data-parallel axis x scenario axis.

    The framework's dp x sp analog: independent problem instances
    (batched receding-horizon runs) shard over BATCH_AXIS with zero
    cross-talk; each instance's scenario tree shards over AXIS with the
    branching-prefix/psum collectives staying inside the scenario
    submesh.
    """
    if devices is None:
        devices = jax.devices()
    if len(devices) < n_batch * n_scen:
        raise ValueError(
            f"requested a {n_batch}x{n_scen} mesh but only "
            f"{len(devices)} devices are visible "
            f"({devices[0].platform}); pass devices= explicitly")
    devices = np.asarray(devices[:n_batch * n_scen]).reshape(
        n_batch, n_scen)
    return Mesh(devices, (BATCH_AXIS, AXIS))


def make_sharded_apg_batch(mesh: Mesh, fa_template: dict,
                           step_template: dict, *, prefix_stages: tuple,
                           inv_step: float, step_size: float,
                           penalty_state: float, penalty_safety: float,
                           xs_upper: float, max_iterations: int,
                           tolerance: float | None = None):
    """Batched AND scenario-sharded APG over a 2-D (batch, scen) mesh.

    fn(fa, steps, y0) where ``steps`` (and the dual warm start ``y0`` —
    pass zeros to cold-start) leaves carry a leading batch axis
    (sharded over BATCH_AXIS) and the scenario/slot axis is sharded
    over AXIS; the factor arrays are shared across the batch.  Returns
    per-instance controls (B, nu) plus the usual outputs with batch and
    scenario shardings.  With ``tolerance``, instances run in masked
    lockstep under vmap (the program exits when the slowest instance
    converges).
    """
    run_core = apg_mod.make_apg(
        prefix_stages=prefix_stages, inv_step=inv_step,
        step_size=step_size, penalty_state=penalty_state,
        penalty_safety=penalty_safety, xs_upper=xs_upper,
        max_iterations=max_iterations,
        axis_name=AXIS, project_control=False, tolerance=tolerance)

    def add_batch(spec):
        return P(BATCH_AXIS, *spec)

    fa_specs = _fa_specs(fa_template)
    step_specs = jax.tree.map(add_batch, _step_specs(step_template))
    y_specs = jax.tree.map(add_batch, _y_specs())
    in_specs = (fa_specs, step_specs, y_specs)
    out_specs = jax.tree.map(add_batch,
                             dict(_base_out_specs(), iterations=P()),
                             is_leaf=lambda x: isinstance(x, P))

    def body(fa, steps, y0):
        return jax.vmap(
            lambda s, y: _broadcast_root_control(run_core(fa, s, y), fa)
        )(steps, y0)

    fn = shard_map(body, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    return _wrap_optional_y0_batch(jax.jit(fn), fa_template)


def shard_step_arrays_batch(steps: dict, mesh: Mesh) -> dict:
    """Place a batched step dict on a 2-D (batch, scen) mesh
    (single-process staging only; see ``_put``)."""
    def spec(v):
        return P(BATCH_AXIS, *( _step_specs({"_": v[0]})["_"] ))
    return {k: _put(v, spec(v), mesh) for k, v in steps.items()}


def shard_shared_step(base: dict, inst: dict, mesh: Mesh) -> tuple:
    """Place the shared-base + per-instance step form
    (Engine.prepare_step_shared) on a 2-D (batch, scen) mesh: the base
    fan arrays shard the scenario axis (replicated over BATCH_AXIS, one
    O(tree) transfer per control step), the per-instance vectors shard
    the batch axis (O(B nu) bytes) — instead of materialising and
    shipping the full O(B x tree) broadcast."""
    base_s = {k: _put(jnp.asarray(v), P(None, AXIS, None), mesh)
              for k, v in base.items()}
    inst_s = {k: _put(jnp.asarray(v), P(BATCH_AXIS, None), mesh)
              for k, v in inst.items()}
    return base_s, inst_s


def make_sharded_batch_shared(mesh: Mesh, fa_template: dict,
                              base_template: dict, inst_template: dict, *,
                              algorithm: str = "proximalAlgorithm",
                              prefix_stages: tuple, inv_step: float,
                              step_size: float, penalty_state: float,
                              penalty_safety: float, xs_upper: float,
                              max_iterations: int,
                              lbfgs_buffer_size: int = 0,
                              tolerance: float | None = None):
    """Batched + scenario-sharded solve with DEVICE-SIDE batch assembly.

    fn(fa, base, inst, y0): ``base`` holds the unbatched fan arrays of
    Engine.prepare_step_shared (scenario-sharded, batch-replicated);
    ``inst`` the per-instance vectors (batch-sharded).  Each shard
    assembles its instances' step dicts locally, so the host->device
    staging per control step is O(tree/n_scen) + O(B nu / n_batch) per
    device.  Supports all three algorithms (``algorithm``).
    """
    from rapidnet_jax.model.config import ALGORITHM_APG
    from rapidnet_jax.solver import quasi_newton
    from rapidnet_jax.solver.apg import expand_shared_step

    common = dict(prefix_stages=prefix_stages, inv_step=inv_step,
                  step_size=step_size, penalty_state=penalty_state,
                  penalty_safety=penalty_safety, xs_upper=xs_upper,
                  max_iterations=max_iterations, axis_name=AXIS,
                  project_control=False, tolerance=tolerance)
    if algorithm == ALGORITHM_APG:
        run_core = apg_mod.make_apg(**common)
        extra_out = dict(iterations=P())
    else:
        run_core = quasi_newton.make_solver(
            algorithm=algorithm, lbfgs_buffer_size=lbfgs_buffer_size,
            **common)
        extra_out = dict(value_fbe=P(), tau=P(), iterations=P())

    def add_batch(spec):
        return P(BATCH_AXIS, *spec)

    base_specs = {k: P(None, AXIS, None) for k in base_template}
    inst_specs = {k: P(BATCH_AXIS, None) for k in inst_template}
    y_specs = jax.tree.map(add_batch, _y_specs())
    in_specs = (_fa_specs(fa_template), base_specs, inst_specs, y_specs)
    out_specs = jax.tree.map(add_batch,
                             dict(_base_out_specs(), **extra_out),
                             is_leaf=lambda x: isinstance(x, P))

    def one(fa, base, x0, pu, puh, dlt, y0):
        step = expand_shared_step(base, x0, pu, puh, dlt)
        return _broadcast_root_control(run_core(fa, step, y0), fa)

    def body(fa, base, inst, y0):
        return jax.vmap(one, in_axes=(None, None, 0, 0, 0, 0, 0))(
            fa, base, inst["x0"], inst["prev_u"], inst["prev_uhat"],
            inst["delta_beta0"], y0)

    fn = shard_map(body, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    jfn = jax.jit(fn)
    N, ns, nx = np.asarray(fa_template["d1"]).shape
    nu = np.asarray(fa_template["g"]).shape[-1]

    def run(fa, base, inst, y0=None):
        if y0 is None:
            B = np.asarray(inst["x0"]).shape[0]
            y0 = {"xi": np.zeros((B, N, ns, 2 * nx), np.float32),
                  "psi": np.zeros((B, N, ns, nu), np.float32)}
        return jfn(fa, base, inst, y0)

    return run


def make_sharded_qn_batch(mesh: Mesh, fa_template: dict,
                          step_template: dict, *, algorithm: str,
                          prefix_stages: tuple, inv_step: float,
                          step_size: float, penalty_state: float,
                          penalty_safety: float, xs_upper: float,
                          max_iterations: int, lbfgs_buffer_size: int,
                          tolerance: float | None = None):
    """Batched + scenario-sharded global-FBE / NAMA over a 2-D mesh.

    Same fn(fa, steps, y0) contract as :func:`make_sharded_apg_batch`.
    Under vmap the line searches and (with ``tolerance``) the
    early-exit run in masked lockstep across instances.
    """
    from rapidnet_jax.solver import quasi_newton

    run_core = quasi_newton.make_solver(
        algorithm=algorithm, prefix_stages=prefix_stages,
        inv_step=inv_step, step_size=step_size,
        penalty_state=penalty_state, penalty_safety=penalty_safety,
        xs_upper=xs_upper, max_iterations=max_iterations,
        lbfgs_buffer_size=lbfgs_buffer_size,
        axis_name=AXIS, project_control=False, tolerance=tolerance)

    def add_batch(spec):
        return P(BATCH_AXIS, *spec)

    step_specs = jax.tree.map(add_batch, _step_specs(step_template))
    y_specs = jax.tree.map(add_batch, _y_specs())
    in_specs = (_fa_specs(fa_template), step_specs, y_specs)
    out_specs = jax.tree.map(
        add_batch, dict(_base_out_specs(), value_fbe=P(), tau=P(),
                        iterations=P()),
        is_leaf=lambda x: isinstance(x, P))

    def body(fa, steps, y0):
        return jax.vmap(
            lambda s, y: _broadcast_root_control(run_core(fa, s, y), fa)
        )(steps, y0)

    fn = shard_map(body, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    return _wrap_optional_y0_batch(jax.jit(fn), fa_template)


def make_sharded_quasi_newton(mesh: Mesh, fa_template: dict,
                              step_template: dict, *, algorithm: str,
                              prefix_stages: tuple, inv_step: float,
                              step_size: float, penalty_state: float,
                              penalty_safety: float, xs_upper: float,
                              max_iterations: int, lbfgs_buffer_size: int,
                              tolerance: float | None = None):
    """Scenario-axis-sharded global-FBE / NAMA solve.

    Same layout and fn(fa, step, y0) signature as
    :func:`make_sharded_apg`; the quasi-Newton extras (L-BFGS dots, FBE
    value, line-search decisions) are global scalars computed with
    masked ``psum``s (quasi_newton.masked_dot), so the line-search and
    early-termination control flow stays identical on every shard.
    """
    from rapidnet_jax.solver import quasi_newton

    run_core = quasi_newton.make_solver(
        algorithm=algorithm, prefix_stages=prefix_stages,
        inv_step=inv_step, step_size=step_size,
        penalty_state=penalty_state, penalty_safety=penalty_safety,
        xs_upper=xs_upper, max_iterations=max_iterations,
        lbfgs_buffer_size=lbfgs_buffer_size,
        axis_name=AXIS, project_control=False, tolerance=tolerance)

    in_specs = (_fa_specs(fa_template), _step_specs(step_template),
                _y_specs())
    out_specs = dict(_base_out_specs(), value_fbe=P(), tau=P(),
                     iterations=P())

    def body(fa, step, y0):
        return _broadcast_root_control(run_core(fa, step, y0), fa)

    fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return _wrap_optional_y0(jax.jit(fn), fa_template, step_template)
