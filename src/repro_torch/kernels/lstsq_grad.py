"""CUDA kernel for the fused least-squares task gradient (wrapper).

Port of `repro/kernels/lstsq_grad.py :: lstsq_grad`; the kernel is
`repro_torch/csrc/lstsq_grad.cu`:

    g = 2 X^T (X w - y),   rows >= n_t masked out of the residual

Two launches (the residuals, then one thread a column), no atomics: the
same inputs give the same bits on every call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2 \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def lstsq_grad(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
               n_t: int | None = None) -> torch.Tensor:
    """(d,) float32 gradient for contiguous float32 CUDA x (n, d), w (d,),
    y (n,); `n_t` (a host int, default n) counts the valid rows, and the
    padded rows past it are never read."""
    global launches
    name = "lstsq_grad"
    dev = _build.require_cuda(name, x=x, w=w, y=y)
    _build.require_dtype(name, torch.float32, x=x, w=w, y=y)
    n, d = _build.lstsq_shapes(name, x, w, y)
    n_t = n if n_t is None else int(n_t)
    if not 0 <= n_t <= n:
        raise ValueError(f"{name}: n_t must lie in [0, {n}], got {n_t}")
    r = torch.empty((n,), dtype=torch.float32, device=dev)
    g = torch.empty((d,), dtype=torch.float32, device=dev)
    fn = _build.function("lstsq_grad_launch", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), n_t, r.data_ptr(),
             g.data_ptr(), n, d, _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return g
