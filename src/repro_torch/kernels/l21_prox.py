"""CUDA kernel for the l2,1 row-group soft threshold (wrapper).

Port of `repro/kernels/l21_prox.py :: l21_prox`; the kernel is
`repro_torch/csrc/l21_prox.cu`.  For a (d, T) float32 or bfloat16 matrix
it returns a new matrix of the same dtype,

    out_i = w_i * max(0, 1 - t / max(||w_i||_2, 1e-12))    for each row i,

computed in float32 (bf16 rounds once on the store).  A warp reduces a
row up to `WIDE_T` columns and a block above; the sum of squares is taken
in a fixed order, so two launches on the same input give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0
WIDE_T = 512               # the kernel takes a block a row above this T

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = {torch.float32: 4, torch.bfloat16: 8}      # elements in 16 bytes
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_float] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]


def l21_prox(w: torch.Tensor, t: float) -> torch.Tensor:
    """(d, T) prox of a contiguous float32 or bfloat16 CUDA matrix; `t`
    is a host number, taken as its float32 value."""
    global launches
    name = "l21_prox"
    dev = _build.require_cuda(name, w=w)
    if w.dtype not in _DTYPES:
        raise ValueError(f"{name}: w must be one of {list(_DTYPES)}, got "
                         f"{w.dtype}")
    if w.dim() != 2:
        raise ValueError(f"{name} expects a (d, T) matrix; got "
                         f"{tuple(w.shape)}")
    d, num_t = w.shape
    thresh = _build.host_scalar("t", t)
    out = torch.empty_like(w)
    if w.numel() == 0:
        return out
    vector = num_t % _CHUNK[w.dtype] == 0 and w.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    fn = _build.function("l21_prox_launch", _ARGTYPES)
    err = fn(w.data_ptr(), out.data_ptr(), thresh, d, num_t,
             _DTYPES[w.dtype], int(vector), _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return out
