"""CUDA kernel for the thresholded low-rank SVT apply (wrapper).

Port of `repro/kernels/svt_reconstruct.py :: svt_reconstruct`; the kernel
is `repro_torch/csrc/svt_reconstruct.cu`: (QU * sigma) @ V^T with the
sigma scale applied on the load of QU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0
MAX_SMEM = 227 * 1024      # one block stages V^T and 32 rows of QU

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def svt_reconstruct(qu: torch.Tensor, s: torch.Tensor,
                    vt: torch.Tensor) -> torch.Tensor:
    """(d, m) float32 from contiguous float32 CUDA qu (d, p), s (p,),
    vt (p, m)."""
    global launches
    name = "svt_reconstruct"
    dev = _build.require_cuda(name, qu=qu, s=s, vt=vt)
    _build.require_dtype(name, torch.float32, qu=qu, s=s, vt=vt)
    if qu.dim() != 2 or vt.dim() != 2 or qu.shape[1] != vt.shape[0] \
            or s.shape != (qu.shape[1],):
        raise ValueError(f"{name} expects qu (d, p), s (p,), vt (p, m); got "
                         f"{tuple(qu.shape)}, {tuple(s.shape)}, "
                         f"{tuple(vt.shape)}")
    d, p = qu.shape
    m = vt.shape[1]
    if p < 1 or 4 * (p * m + 32 * p) > MAX_SMEM:
        raise ValueError(f"{name}: p={p}, m={m} does not fit one block's "
                         "shared memory")
    out = torch.empty((d, m), dtype=torch.float32, device=dev)
    fn = _build.function("svt_reconstruct_launch", _ARGTYPES)
    err = fn(qu.data_ptr(), s.data_ptr(), vt.data_ptr(), out.data_ptr(),
             d, p, m, _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return out
