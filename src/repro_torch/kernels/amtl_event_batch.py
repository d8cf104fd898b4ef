"""CUDA kernel for the batched AMTL multi-event column update (wrapper).

Port of `repro/kernels/amtl_event_batch.py :: amtl_event_batch`; the
kernel is `repro_torch/csrc/amtl_event_batch.cu`.  It updates V IN PLACE:
the batch engine owns the (d, T) iterate it passes (a clone made once per
`run`), so no (d, T) copy is made per batch.

A block takes a tile of rows of V, staged whole in shared memory, and
writes the tile back whole, coalesced.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def amtl_event_batch(v: torch.Tensor, p_cols: torch.Tensor,
                     g_cols: torch.Tensor, tasks: torch.Tensor, eta: float,
                     eta_ks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply B column events to `v` (d, T) in place; returns (v, undo (B, d)).

    p_cols/g_cols: (d, B) float32; tasks: (B,) int32; eta_ks: (B,) float32,
    all contiguous on one CUDA device.  Duplicate tasks serialize in event
    order; ids outside [0, T) are dropped (see the kernel's note).
    """
    global launches
    name = "amtl_event_batch"
    dev = _build.require_cuda(name, v=v, p_cols=p_cols, g_cols=g_cols,
                              tasks=tasks, eta_ks=eta_ks)
    _build.require_dtype(name, torch.float32, v=v, p_cols=p_cols,
                         g_cols=g_cols, eta_ks=eta_ks)
    _build.require_dtype(name, torch.int32, tasks=tasks)
    if v.dim() != 2 or tasks.dim() != 1:
        raise ValueError(f"{name}: v must be (d, T) and tasks (B,); got "
                         f"{tuple(v.shape)}, {tuple(tasks.shape)}")
    d, num_t = v.shape
    b = tasks.shape[0]
    if p_cols.shape != (d, b) or g_cols.shape != (d, b) \
            or eta_ks.shape != (b,):
        raise ValueError(f"{name}: p_cols/g_cols must be ({d}, {b}) and "
                         f"eta_ks ({b},); got {tuple(p_cols.shape)}, "
                         f"{tuple(g_cols.shape)}, {tuple(eta_ks.shape)}")
    if _tile_rows(num_t, b) == 0:
        raise ValueError(f"{name}: a row of V ({num_t}) with its p and g "
                         f"({b}) does not fit in a block's shared memory")
    undo = torch.empty((b, d), dtype=v.dtype, device=dev)
    fn = _build.function("amtl_event_batch_launch", _ARGTYPES)
    err = fn(v.data_ptr(), p_cols.data_ptr(), g_cols.data_ptr(),
             tasks.data_ptr(), eta_ks.data_ptr(),
             _build.host_scalar("eta", eta), undo.data_ptr(), d, num_t, b,
             _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return v, undo


@functools.cache
def _tile_rows(num_t: int, b: int) -> int:
    """The rows of V a block takes at (T, B); 0 if not one fits."""
    return _build.function("amtl_event_batch_rows",
                           [ctypes.c_int, ctypes.c_int])(num_t, b)
