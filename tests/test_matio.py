"""MAT-v5 reader tests against the reference's real data source.

dwn.mat (src/paser/dataSource/) holds the reference's real problem
data: the 3-tank network struct S, controller parameters P (including
a full year of hourly electricity prices) and a year of measured
hourly demands — consumed by load('dwn') in the MATLAB preprocessing
(src/paser/createDwnDataJson.m).
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest

from rapidnet_jax.io.matio import (load_dwn_forecaster, load_dwn_network,
                                   read_mat)

DWN_MAT = "/root/reference/src/paser/dataSource/dwn.mat"

requires_mat = pytest.mark.skipif(not os.path.isfile(DWN_MAT),
                                  reason="dwn.mat not available")


@requires_mat
def test_read_mat_variables():
    m = read_mat(DWN_MAT)
    assert sorted(m.keys()) == ["DemandData", "P", "S"]
    # a full year of hourly demand data
    assert m["DemandData"].shape == (8760, 4)
    # spot values (verified against MATLAB/scipy loads of the file)
    np.testing.assert_allclose(m["DemandData"][0, 0], 0.0042116095,
                               rtol=1e-6)
    S, P = m["S"], m["P"]
    assert (int(S["nx"].ravel()[0]) == 3 and
            int(S["nu"].ravel()[0]) == 6 and
            int(S["nd"].ravel()[0]) == 4)
    np.testing.assert_allclose(S["A"], np.eye(3))
    np.testing.assert_allclose(S["xmax"].ravel(), [470.0, 960.0, 3100.0])
    np.testing.assert_allclose(P["xs"].ravel(), [42.0, 18.0, 270.0])
    assert P["alpha2"].shape == (8760, 6)
    np.testing.assert_allclose(float(P["beta"].ravel()[0]), 0.8)
    # integer-stored matrices decode with correct dims and column order
    assert S["B"].shape == (3, 6) and S["E"].shape == (2, 6)
    assert S["Ed"].shape == (2, 4) and S["Gd"].shape == (3, 4)


@requires_mat
def test_dwn_network_matches_reference_fixture_geometry():
    """The mat network is the reference's 3-tank test network in
    different flow units (m^3/s vs the JSON fixture's m^3/h):
    E (dimensionless junction incidence), xmax/xmin (volumes) and the
    safety level match exactly; flow bounds scale by 3600."""
    from rapidnet_jax.model.network import DwnNetwork
    fixture = "/root/reference/src/test/testDataFiles/network.json"
    if not os.path.isfile(fixture):
        pytest.skip("reference fixture not available")
    net = load_dwn_network(DWN_MAT)
    ref = DwnNetwork.from_json(fixture)
    assert (net.nx, net.nu, net.nd, net.ne) == (ref.nx, ref.nu,
                                                ref.nd, ref.ne)
    np.testing.assert_allclose(net.matE, ref.matE)
    np.testing.assert_allclose(net.xmax, ref.xmax)
    np.testing.assert_allclose(net.xsafe, ref.xsafe)
    np.testing.assert_allclose(net.umax * 3600.0, ref.umax, rtol=1e-6)


@requires_mat
def test_real_year_forecaster_closed_loop():
    """A short closed loop over the REAL demand/price year runs and
    produces feasible controls on the mat-file network."""
    from rapidnet_jax.engine.engine import Engine
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.scenario_tree import generate_tree
    from rapidnet_jax.solver.controller import SmpcController

    net = load_dwn_network(DWN_MAT)
    # units: volumes m^3, controls/demands m^3/s; B/Gd already
    # integrate the 3600 s control step (entries +/-3600)
    N = 12
    tree = generate_tree(N=N, branching=[2], nd=net.nd, nu=net.nu, seed=3)
    fc = load_dwn_forecaster(DWN_MAT, N=N, start=0, hours=N + 4)
    cfg = synthetic_config(net, tree, max_iterations=150)
    cfg.current_x = (0.5 * net.xmax).astype(np.float32)
    ctrl = SmpcController(cfg, network=net, tree=tree, forecaster=fc)
    for t in range(3):
        u = ctrl.control_action(t)
        assert np.all(np.isfinite(u))
        assert np.all(u <= net.umax * 1.01 + 1e-6)
        ctrl.move_forward_in_time()
    assert np.all(np.isfinite(ctrl.config.current_x))


def _tag(mi_type, payload):
    pad = (-len(payload)) % 8
    return struct.pack("<II", mi_type, len(payload)) + payload + b"\0" * pad


def _matrix_bytes(name, arr):
    arr = np.asarray(arr, np.float64)
    flags = _tag(6, struct.pack("<II", 6, 0))                 # mxDOUBLE
    dims = _tag(5, struct.pack("<ii", *arr.shape))
    nm = _tag(1, name.encode())
    data = _tag(9, arr.T.tobytes())                           # col-major
    return _tag(14, flags + dims + nm + data)


def test_read_mat_synthetic_roundtrip(tmp_path):
    """Hand-built MAT-v5 bytes (plain + compressed) decode correctly."""
    a = np.arange(6, dtype=np.float64).reshape(2, 3) + 0.5
    b = np.array([[7.0]])
    header = b"MATLAB 5.0 MAT-file, test".ljust(124) + \
        struct.pack("<H", 0x0100) + b"IM"
    plain = _matrix_bytes("a", a)
    comp_inner = _matrix_bytes("b", b)
    comp = struct.pack("<II", 15, len(zlib.compress(comp_inner))) + \
        zlib.compress(comp_inner)
    p = tmp_path / "t.mat"
    p.write_bytes(header + plain + comp)
    m = read_mat(p)
    np.testing.assert_allclose(m["a"], a)
    np.testing.assert_allclose(m["b"], b)


def test_read_mat_rejects_non_mat(tmp_path):
    p = tmp_path / "x.mat"
    p.write_bytes(b"\x89HDF\r\n" + b"\0" * 200)
    with pytest.raises(ValueError):
        read_mat(p)
