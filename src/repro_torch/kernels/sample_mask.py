"""CUDA kernel for the minibatch selection bits alone (wrapper).

Port of `repro/kernels/lstsq_grad_sampled.py :: sample_mask`; the kernel
(`sample_mask_kernel`) sits in `repro_torch/csrc/lstsq_grad_sampled.cu`
beside the gradient whose selection it exposes, and both evaluate the one
`keep_bit` of `csrc/counter_hash.cuh`.  One thread a row writes its keep
bit; the result is bitwise `ref.keep_bits_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGTYPES = [ctypes.c_uint] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]


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
