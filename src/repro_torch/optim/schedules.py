"""Learning-rate schedules (port of `repro/optim/schedules.py`): pure
functions of a host step that give a numpy float32, computed in float32
as the reference's jnp arithmetic computes them."""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant(lr: float):
    return lambda step: _F(lr)


def linear_warmup(lr: float, warmup: int):
    def fn(step):
        s = _F(step)
        return _F(lr) * np.minimum(_F(1.0), (s + _F(1.0)) / _F(max(warmup, 1)))
    return fn


def cosine_warmup(lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        s = _F(step)
        warm = np.minimum(_F(1.0), (s + _F(1.0)) / _F(max(warmup, 1)))
        prog = np.clip((s - _F(warmup)) / _F(max(total - warmup, 1)),
                       _F(0.0), _F(1.0))
        # (1 - floor) * 0.5 is a Python float there, rounded once
        cos = _F(floor) + _F((1.0 - floor) * 0.5) * (
            _F(1.0) + np.cos(_F(np.pi) * prog))
        return _F(lr) * warm * cos
    return fn
