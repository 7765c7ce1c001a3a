"""Parity with the reference's larger data sources (src/paser/dataSource)."""

import os

import numpy as np
import pytest

DS = "/root/reference/src/paser/dataSource"

requires_ds = pytest.mark.skipif(not os.path.isdir(DS),
                                 reason="reference dataSource unavailable")


@requires_ds
def test_scenario_tree_32_loads():
    from rapidnet_jax.model.scenario_tree import ScenarioTree
    t = ScenarioTree.from_json(os.path.join(DS, "scenarioTree32.json"))
    assert (t.N, t.ns, t.n_nodes) == (24, 6, 136)
    assert t.err_demand.shape == (t.n_nodes, t.dim_demand)
    # fan layout invariants
    assert t.prob[0] == pytest.approx(1.0, abs=1e-6)


@requires_ds
def test_scenario_tree_65_loads_and_factors():
    """667-node tree: load + run the offline factor step end-to-end."""
    from rapidnet_jax.engine.engine import Engine
    from rapidnet_jax.model.config import synthetic_config
    from rapidnet_jax.model.network import synthetic_network
    from rapidnet_jax.model.scenario_tree import ScenarioTree

    t = ScenarioTree.from_json(os.path.join(DS, "scenarioTree65.json"))
    assert (t.N, t.ns, t.n_nodes) == (24, 30, 667)
    net = synthetic_network(nx=5, nu=9, nd=t.dim_demand, ne=3, seed=0)
    cfg = synthetic_config(net, t, max_iterations=10)
    eng = Engine(net, t, cfg)
    fd = eng.factor_step()
    assert fd.d1.shape == (24, 30, 5)
    assert np.isfinite(fd.invWbar).all()


@requires_ds
def test_controller_config_32_parses():
    from rapidnet_jax.model.config import SmpcConfig
    cfg = SmpcConfig.from_json(os.path.join(DS, "controllerConfig32.json"))
    assert cfg.N == 24
    assert cfg.max_iterations > 0
    assert cfg.mat_l is not None and cfg.mat_l.shape == (cfg.nu, cfg.nv)
    assert cfg.diag_precnd.shape == (cfg.N, cfg.nu + 2 * cfg.nx)


@requires_ds
def test_germany2016_price_workbook():
    """Legacy-.xls reader (io/xls.py) on the shipped electricity prices."""
    from rapidnet_jax.io.xls import load_hourly_prices, read_xls_numbers
    path = os.path.join(DS, "germany2016.xls")
    book = read_xls_numbers(path)
    assert "Price (EUR)" in book
    assert len(book["Price (EUR)"]) > 9000
    prices = load_hourly_prices(path)
    assert len(prices) == 366 * 24      # hourly, leap year
    assert -200 < prices.mean() < 200   # plausible EUR/MWh
    assert np.isfinite(prices).all()


@requires_ds
def test_prices_drive_forecaster():
    """Real 2016 price data feeding the controller's forecaster."""
    from rapidnet_jax.io.xls import load_hourly_prices
    from rapidnet_jax.model.forecaster import ArrayForecaster

    prices = load_hourly_prices(os.path.join(DS, "germany2016.xls"))
    N, nd = 24, 4
    demands = np.abs(np.random.default_rng(0).normal(
        1.0, 0.1, (10 + N, nd))).astype(np.float32)
    fc = ArrayForecaster(demands, prices[:10 + N, None], N=N)
    assert fc.predict_demand(3) and fc.predict_prices(3)
    np.testing.assert_allclose(
        np.asarray(fc.nominal_prices).reshape(-1), prices[3:3 + N])
