"""CUDA kernel for the unmaterialized Gaussian sketch W @ Omega (wrapper).

Port of `repro/kernels/gauss_sketch.py :: gauss_sketch`; the kernel is
`repro_torch/csrc/gauss_sketch.cu`.  Omega's entry (r, c) is the
Box-Muller normal of `ref.gauss_from_counters(seed, (row_offset + r)*p + c)`,
generated in shared memory and never written to device memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0
MAX_P = 256        # the kernel's shared-memory Omega tile holds p <= 256

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def gauss_sketch(w: torch.Tensor, seed: int, row_offset: int,
                 p: int) -> torch.Tensor:
    """(d, p) float32 sketch of a contiguous float32 (d, t) CUDA tensor."""
    global launches
    dev = _build.require_cuda("gauss_sketch", w=w)
    _build.require_dtype("gauss_sketch", torch.float32, w=w)
    if w.dim() != 2:
        raise ValueError(f"gauss_sketch expects w as (d, t), got "
                         f"{tuple(w.shape)}")
    if not 1 <= p <= MAX_P:
        raise ValueError(f"gauss_sketch supports 1 <= p <= {MAX_P}, got {p}")
    d, tt = w.shape
    out = torch.empty((d, p), dtype=torch.float32, device=dev)
    fn = _build.function("gauss_sketch_launch", _ARGTYPES)
    err = fn(w.data_ptr(), out.data_ptr(), int(seed) & 0xFFFFFFFF,
             int(row_offset), d, tt, p, _build.stream(dev))
    _build.check(err, "gauss_sketch")
    launches += 1
    return out
