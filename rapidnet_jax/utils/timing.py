"""Timing + profiling helpers.

Reference counterpart: the cudaEvent tic/toc of src/Utilities.cu:428-471
(0.5 us resolution, used by main.cu:55-59 to log per-solve wall ms).
Here the analog is host wall-clock around ``block_until_ready`` plus
``jax.profiler`` traces for kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import time

import jax


class TicToc:
    """Host wall-clock timer with device synchronisation."""

    def __init__(self):
        self._t0 = None
        self.history_ms: list[float] = []

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, *sync_arrays) -> float:
        """Elapsed ms; blocks on the given device arrays first."""
        for a in sync_arrays:
            jax.block_until_ready(a)
        if self._t0 is None:
            raise RuntimeError("toc() called without tic()")
        ms = (time.perf_counter() - self._t0) * 1e3
        self.history_ms.append(ms)
        self._t0 = None
        return ms


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
