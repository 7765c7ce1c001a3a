"""Demand/price forecaster.

Reference counterpart: ``Forecaster`` (src/Forecaster.cu:27-119).  The
reference reads per-timestep nominal demand/price vectors from a JSON
whose members are time-indexed (``timeIdDemand<t0+t>`` at document member
offset ``4 + 2t``, ``timeIdPrice<t0+t>`` at ``5 + 2t``); the class is
virtual so a real forecaster can subclass.  We keep that contract and add
an array-backed forecaster for synthetic runs.
"""

from __future__ import annotations

import numpy as np

from rapidnet_jax.io import jsonio


class Forecaster:
    """Base: nominal demand (N, nd) and price (N, nu) per sim timestep."""

    def __init__(self, N: int, dim_demand: int, dim_prices: int,
                 sim_horizon: int):
        self.N = N
        self.dim_demand = dim_demand
        self.dim_prices = dim_prices
        self.sim_horizon = sim_horizon
        self.nominal_demand = np.zeros((N, dim_demand), np.float32)
        self.nominal_prices = np.zeros((N, dim_prices), np.float32)

    # reference API (src/Forecaster.cu:93-119)
    def predict_demand(self, sim_time: int) -> bool:
        raise NotImplementedError

    def predict_prices(self, sim_time: int) -> bool:
        raise NotImplementedError


class JsonForecaster(Forecaster):
    """Reference-format JSON forecaster (time-indexed member pairs)."""

    def __init__(self, path):
        doc = jsonio.load_json(path)
        N = jsonio.scalar(doc, "N")
        super().__init__(
            N=N,
            dim_demand=jsonio.scalar(doc, "dimDemand"),
            dim_prices=jsonio.scalar(doc, "dimPrices"),
            sim_horizon=jsonio.scalar(doc, "simHorizon"),
        )
        # member order mirrors the reference's iterator-offset access
        # (src/Forecaster.cu:94,108): members 4+2t / 5+2t
        keys = list(doc.keys())
        self._demand_keys = keys[4::2]
        self._price_keys = keys[5::2]
        self._doc = doc

    def predict_demand(self, sim_time: int) -> bool:
        if sim_time >= len(self._demand_keys):
            return False
        flat = np.asarray(self._doc[self._demand_keys[sim_time]], np.float32)
        self.nominal_demand = flat.reshape(self.N, self.dim_demand)
        return True

    def predict_prices(self, sim_time: int) -> bool:
        if sim_time >= len(self._price_keys):
            return False
        flat = np.asarray(self._doc[self._price_keys[sim_time]], np.float32)
        self.nominal_prices = flat.reshape(self.N, self.dim_prices)
        return True


class ArrayForecaster(Forecaster):
    """Forecaster backed by in-memory arrays (synthetic/bench path).

    demand: (sim_horizon + N, nd) time series; the prediction at sim time
    t is the window [t, t+N).  Same for prices.
    """

    def __init__(self, demand_series: np.ndarray, price_series: np.ndarray,
                 N: int):
        demand_series = np.asarray(demand_series, np.float32)
        price_series = np.asarray(price_series, np.float32)
        sim_horizon = demand_series.shape[0] - N
        super().__init__(N=N, dim_demand=demand_series.shape[1],
                         dim_prices=price_series.shape[1],
                         sim_horizon=max(sim_horizon, 0))
        self._demand = demand_series
        self._price = price_series

    def predict_demand(self, sim_time: int) -> bool:
        if sim_time + self.N > self._demand.shape[0]:
            return False
        self.nominal_demand = self._demand[sim_time:sim_time + self.N]
        return True

    def predict_prices(self, sim_time: int) -> bool:
        if sim_time + self.N > self._price.shape[0]:
            return False
        self.nominal_prices = self._price[sim_time:sim_time + self.N]
        return True


def synthetic_forecaster(N: int, nd: int, nu: int, sim_horizon: int = 24,
                         seed: int = 0) -> ArrayForecaster:
    """Diurnal-pattern synthetic demand/price series for benchmarks."""
    rng = np.random.default_rng(seed)
    t = np.arange(sim_horizon + N)
    base_d = rng.uniform(0.05, 0.4, nd)
    demand = (base_d[None, :] *
              (1.0 + 0.5 * np.sin(2 * np.pi * t[:, None] / 24.0 +
                                  rng.uniform(0, 6, nd)[None, :])))
    base_p = rng.uniform(0.02, 0.15, nu)
    price = (base_p[None, :] *
             (1.0 + 0.3 * np.cos(2 * np.pi * t[:, None] / 24.0 +
                                 rng.uniform(0, 6, nu)[None, :])))
    return ArrayForecaster(demand.astype(np.float32),
                           price.astype(np.float32), N)
