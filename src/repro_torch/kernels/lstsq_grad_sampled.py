"""CUDA kernel for the seeded-minibatch least-squares gradient (wrapper).

Port of `repro/kernels/lstsq_grad_sampled.py :: lstsq_grad_sampled`; the
kernel is `repro_torch/csrc/lstsq_grad_sampled.cu`:

    g = (n_t/bsz) * 2 X_S^T (X_S w - y_S),   bsz = min(batch_size, n_t)

Row i is in S iff its keep bit, a local predicate over counter_hash(seed,
i) and the event's scalar block (seed, cut_h, cut_i, n_t), is set.  The
block is planned on the host (`ref.sample_scalars`) and passed by value in
the launch's arguments.  Two launches, no atomics: the same inputs give
the same bits on every call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_uint] * 4 + [ctypes.c_int] \
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def lstsq_grad_sampled(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                       scalars, batch_size: int) -> torch.Tensor:
    """(d,) float32 minibatch gradient for contiguous float32 CUDA x (n, d),
    w (d,), y (n,); `scalars` is the event's host (seed, cut_h, cut_i, n_t).
    Only the kept rows of x are read."""
    global launches
    name = "lstsq_grad_sampled"
    dev = _build.require_cuda(name, x=x, w=w, y=y)
    _build.require_dtype(name, torch.float32, x=x, w=w, y=y)
    n, d = _build.lstsq_shapes(name, x, w, y)
    seed, cut_h, cut_i, n_t = _build.scalar_block(name, scalars)
    if batch_size < 1:
        raise ValueError(f"{name}: batch_size must be >= 1, got {batch_size}")
    r = torch.empty((n,), dtype=torch.float32, device=dev)
    g = torch.empty((d,), dtype=torch.float32, device=dev)
    fn = _build.function("lstsq_grad_sampled_launch", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), seed, cut_h, cut_i,
             n_t, int(batch_size), r.data_ptr(), g.data_ptr(), n, d,
             _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return g
