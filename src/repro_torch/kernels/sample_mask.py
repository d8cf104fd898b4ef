"""CUDA kernels for the minibatch selection bits (wrapper).

Port of `repro/kernels/lstsq_grad_sampled.py :: sample_mask`; the kernels
(`sample_mask_kernel`, `sample_rows_kernel`) sit in
`repro_torch/csrc/lstsq_grad_sampled.cu` beside the gradient whose
selection they expose, and all evaluate the one `keep_bit` of
`csrc/counter_hash.cuh`.  `sample_mask` writes the (n,) keep bits, one
thread a row, bitwise `ref.keep_bits_ref`.  `sample_rows` is the engines'
form: the rows of x kept by those bits and zeros for the others in one
launch, bitwise `ref.sample_rows_ref` (the bits, then `torch.where`); it
counts under this module's `launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGTYPES = [ctypes.c_uint] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
_ROWS_ARGTYPES = [ctypes.c_uint] * 4 + [ctypes.c_void_p] * 2 \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def sample_mask(n: int, scalars, device: torch.device | str) -> torch.Tensor:
    """(n,) bool keep bits of the host scalar block (seed, cut_h, cut_i,
    n_t), written on the CUDA `device`."""
    global launches
    name = "sample_mask"
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{name}: device must be a CUDA device, got {dev}")
    if n < 0:
        raise ValueError(f"{name}: n must be >= 0, got {n}")
    seed, cut_h, cut_i, n_t = _build.scalar_block(name, scalars)
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    fn = _build.function("sample_mask_launch", _ARGTYPES)
    err = fn(seed, cut_h, cut_i, n_t, out.data_ptr(), n, _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return out


def sample_rows(x: torch.Tensor, scalars) -> torch.Tensor:
    """(n, d) float32: row i of the contiguous float32 CUDA x (n, d) where
    the host scalar block's keep bit i is set, 0 elsewhere.  A dropped row
    of x is never read."""
    global launches
    name = "sample_rows"
    _build.require_dtype(name, torch.float32, x=x)
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (n, d), got {tuple(x.shape)}")
    seed, cut_h, cut_i, n_t = _build.scalar_block(name, scalars)
    dev = _build.require_cuda(name, x=x)
    n, d = x.shape
    out = torch.empty_like(x)
    fn = _build.function("sample_rows_launch", _ROWS_ARGTYPES)
    err = fn(seed, cut_h, cut_i, n_t, x.data_ptr(), out.data_ptr(), n, d,
             _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return out
