"""Delay-adaptive dynamic step size (paper Sec. III-D, Eq. III.5/III.6).

The KM relaxation of task t at event k is scaled by

    c_(t,k) = log(max(nu_bar_{t,k}, 10))

where nu_bar is the mean of the node's recent communication delays (the
paper averages the last 5).

The history depends only on the event stream, never on the iterate, so the
port keeps it on the host as float32/int32 numpy arrays, in the
reference's layout.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class DelayHistory(NamedTuple):
    """Per-task ring buffer of recent delays."""

    buf: np.ndarray     # (T, window) float32, initialized to zero
    count: np.ndarray   # (T,) int32 — number of delays recorded so far

    @staticmethod
    def create(num_tasks: int, window: int = 5) -> "DelayHistory":
        return DelayHistory(np.zeros((num_tasks, window), np.float32),
                            np.zeros((num_tasks,), np.int32))

    def copy(self) -> "DelayHistory":
        return DelayHistory(self.buf.copy(), self.count.copy())

    def record(self, task: int, delay) -> "DelayHistory":
        """A new history with `delay` recorded for `task`."""
        out = self.copy()
        out.record_(task, delay)
        return out

    def record_(self, task: int, delay) -> None:
        """Record `delay` for `task` in place (the engines' hot path)."""
        window = self.buf.shape[1]
        self.buf[task, self.count[task] % window] = np.float32(delay)
        self.count[task] += 1

    def mean_delay(self, task: int) -> np.float32:
        """Mean of the recorded delays for `task` (0 if none yet)."""
        n = min(int(self.count[task]), self.buf.shape[1])
        if n <= 0:
            return np.float32(0.0)
        return np.float32(self.buf[task].sum(dtype=np.float32) / np.float32(n))

    def mean_delay_all(self) -> np.ndarray:
        """(T,) vector of per-task mean recent delays."""
        n = np.minimum(self.count, self.buf.shape[1])
        total = self.buf.sum(axis=1, dtype=np.float32)
        return np.where(n > 0, total / np.maximum(n, 1).astype(np.float32),
                        np.float32(0.0)).astype(np.float32)


def dynamic_multiplier(mean_delay) -> np.float32:
    """c = log(max(nu_bar, 10)) — Eq. III.6 (natural log, >= log 10)."""
    return np.log(np.maximum(np.float32(mean_delay), np.float32(10.0)))
