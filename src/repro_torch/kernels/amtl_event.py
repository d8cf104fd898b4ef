"""CUDA kernel for the fused AMTL delta-ring column event (wrapper).

Port of `repro/kernels/amtl_event.py :: amtl_event`; the kernel is
`repro_torch/csrc/amtl_event.cu`.  For one (d,) column:

    v_new = v + eta_k * (p - eta*g - v)     (Eq. III.4, the fma form)
    old   = v                               (undo-log entry, exact bits)

Two entry points, both counted as `amtl_event` launches: `amtl_event`
takes contiguous columns and returns new tensors; `amtl_event_inplace`
works on the delta engine's own state, column t of the (d, T) iterate V
updated in place and its pre-write bits written into slot `slot` of the
(depth, d) undo ring, in one launch (the reference's `amtl_event`, then
`v.at[:, t].set(v_new)` and `delta_ring.at[slot].set(old)`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_float] * 2 \
    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
_INPLACE_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2 \
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def amtl_event(v_t: torch.Tensor, p_t: torch.Tensor, g_t: torch.Tensor,
               eta: float, eta_k: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(v_new, old) for contiguous float32 (d,) CUDA columns."""
    global launches
    dev = _build.require_cuda("amtl_event", v_t=v_t, p_t=p_t, g_t=g_t)
    _build.require_dtype("amtl_event", torch.float32, v_t=v_t, p_t=p_t,
                         g_t=g_t)
    if v_t.dim() != 1 or p_t.shape != v_t.shape or g_t.shape != v_t.shape:
        raise ValueError("amtl_event expects three (d,) columns; got "
                         f"{tuple(v_t.shape)}, {tuple(p_t.shape)}, "
                         f"{tuple(g_t.shape)}")
    v_new = torch.empty_like(v_t)
    old = torch.empty_like(v_t)
    fn = _build.function("amtl_event_launch", _ARGTYPES)
    err = fn(v_t.data_ptr(), p_t.data_ptr(), g_t.data_ptr(),
             _build.host_scalar("eta", eta), _build.host_scalar("eta_k", eta_k),
             v_new.data_ptr(), old.data_ptr(), v_t.shape[0],
             _build.stream(dev))
    _build.check(err, "amtl_event")
    launches += 1
    return v_new, old


def amtl_event_inplace(v: torch.Tensor, t, p_t: torch.Tensor,
                       g_t: torch.Tensor, eta: float, eta_k: float,
                       ring: torch.Tensor, slot) -> None:
    """Column t of the CUDA iterate v updated in place, its pre-write bits
    into ring[slot]; one launch, nothing allocated."""
    global launches
    name = "amtl_event_inplace"
    dev = _build.require_cuda(name, v=v, p_t=p_t, g_t=g_t, ring=ring)
    t, slot = _build.amtl_event_inplace_args(v, t, p_t, g_t, ring, slot)
    eta32 = _build.host_scalar("eta", eta)
    eta_k32 = _build.host_scalar("eta_k", eta_k)
    d, num_t = v.shape
    if d == 0:
        return
    fn = _build.function("amtl_event_inplace_launch", _INPLACE_ARGTYPES)
    err = fn(v.data_ptr(), t, num_t, p_t.data_ptr(), g_t.data_ptr(), eta32,
             eta_k32, ring.data_ptr() + 4 * slot * d, d, _build.stream(dev))
    _build.check(err, name)
    launches += 1
