"""Real-data Barcelona problem assembly (io/datasource.py).

The reference ships the REAL Barcelona-scale controller data
(src/paser/dataSource/controllerConfig32.json: matL/matLhat/costW/
preconditioner/penalties/initial state) and real scenario trees with
real uncertainty vectors (scenarioTree32/65.json) — but NOT the network
topology (pathToNetwork points to a file absent from the repository).
These tests pin the real components and the documented provenance of
the synthetic remainder.
"""

import numpy as np
import pytest

from rapidnet_jax.io import datasource as ds

requires_ds = pytest.mark.skipif(not ds.available(),
                                 reason="reference dataSource unavailable")


@requires_ds
def test_real_config_values():
    cfg = ds.real_config()
    assert (cfg.nx, cfg.nu, cfg.nd, cfg.nv) == (63, 114, 88, 97)
    assert cfg.N == 24 and cfg.max_iterations == 500
    # the real problem's penalties and step size
    assert cfg.penalty_state == pytest.approx(1e10)
    assert cfg.penalty_safety == pytest.approx(1e7)
    assert cfg.step_size == pytest.approx(1e-4)
    assert cfg.diag_precnd.shape == (24, 114 + 2 * 63)
    # real initial volumes
    assert cfg.current_x.min() >= 0 and cfg.current_x.max() > 1e4


@requires_ds
def test_reconstructed_nullspace_geometry_is_exact():
    """E (orthogonal complement of the real matL) and Ed := -E matLhat
    reproduce the real null-space geometry: E L = 0 and E Lhat = -Ed
    hold to f32 precision, so the Engine consumes the REAL basis."""
    cfg = ds.real_config()
    net = ds.real_network(cfg)
    assert net.ne == cfg.nu - cfg.nv == 17
    assert np.abs(net.matE @ cfg.mat_l).max() < 1e-5
    assert np.abs(net.matE @ cfg.mat_lhat + net.matEd).max() < 1e-5
    # E rows orthonormal (the complement basis construction)
    np.testing.assert_allclose(net.matE @ net.matE.T, np.eye(17),
                               atol=1e-5)


@requires_ds
def test_barcelona_problem_factor_step_real_data():
    """The offline factor step runs on the real cost/preconditioner/
    tree data and produces finite, well-conditioned factors."""
    from rapidnet_jax.engine.engine import Engine

    cfg, net, tree, fc = ds.load_barcelona_problem(max_iterations=10)
    assert (tree.N, tree.ns, tree.n_nodes) == (24, 6, 136)
    eng = Engine(net, tree, cfg)
    fd = eng.factor_step()
    assert np.isfinite(fd.invWbar).all()
    assert fd.d1.shape == (24, 6, 63)
    # real preconditioner is nontrivial (not all-ones)
    assert fd.d1.std() > 0


@requires_ds
def test_barcelona_closed_loop_short():
    """Two closed-loop steps on the real-data problem produce finite
    controls within the PHYSICAL bounds.

    This pins the deliberate deviation from the reference's final
    projection (which clips onto preconditionConstraintU-scaled bounds,
    src/Engine.cu:447-448 + src/SmpcController.cu:1649 — with the real
    Barcelona preconditioner, g in [0.005, 1.5], that admits controls
    25% above umax; see solve_step.root_control_bounds)."""
    from rapidnet_jax.solver.controller import SmpcController

    cfg, net, tree, fc = ds.load_barcelona_problem(max_iterations=60)
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc)
    for t in range(2):
        u = ctrl.control_action(t)
        assert np.isfinite(u).all()
        assert np.all(u >= net.umin - 1e-4)
        assert np.all(u <= net.umax + 1e-4 * np.abs(net.umax))
        ctrl.move_forward_in_time()
    assert np.isfinite(ctrl.config.current_x).all()


@requires_ds
def test_provenance_documented():
    assert "matL" in ds.BARCELONA_PROVENANCE["real"]
    assert "matB" in ds.BARCELONA_PROVENANCE["synthetic"]
