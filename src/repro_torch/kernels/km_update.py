"""CUDA kernel for the fused AMTL/KM block update (wrapper).

Port of `repro/kernels/km_update.py :: km_update`; the kernel is
`repro_torch/csrc/km_update.cu`.  Elementwise over contiguous tensors of
one shape and dtype (float32, or bfloat16 computed in float32):

    out = v + eta_k * (p - eta*g - v)       (Eq. III.4, the fma form)

bitwise `ref.km_update_ref`.  Two entry points, both counted as
`km_update` launches: `km_update` on contiguous operands, returning a new
tensor; and `km_update_slot`, the dense engine's event on its own
(depth, d, T) float32 ring: ring[dst] written whole from ring[src] with
column t updated (the reference's `v_cur.at[:, t].set(...)` and
`ring.at[ptr].set(v_new)`), or, where src == dst (tau 0), column t alone
in place, in one launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_float] * 2 \
    + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
_SLOT_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 5 \
    + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2 \
    + [ctypes.c_int, ctypes.c_void_p]


def km_update(v: torch.Tensor, p: torch.Tensor, g: torch.Tensor, eta: float,
              eta_k: float) -> torch.Tensor:
    """A new tensor of v's shape and dtype; eta and eta_k are host numbers,
    taken as their float32 values."""
    global launches
    name = "km_update"
    dev = _build.require_cuda(name, v=v, p=p, g=g)
    if v.dtype not in _DTYPES or p.dtype != v.dtype or g.dtype != v.dtype:
        raise ValueError(f"{name}: v, p, g must share one dtype of "
                         f"{list(_DTYPES)}; got {v.dtype}, {p.dtype}, "
                         f"{g.dtype}")
    if p.shape != v.shape or g.shape != v.shape:
        raise ValueError(f"{name} expects v, p, g of one shape; got "
                         f"{tuple(v.shape)}, {tuple(p.shape)}, "
                         f"{tuple(g.shape)}")
    eta32 = _build.host_scalar("eta", eta)
    eta_k32 = _build.host_scalar("eta_k", eta_k)
    out = torch.empty_like(v)
    if v.numel() == 0:
        return out
    fn = _build.function("km_update_launch", _ARGTYPES)
    err = fn(v.data_ptr(), p.data_ptr(), g.data_ptr(), eta32, eta_k32,
             out.data_ptr(), v.numel(), _DTYPES[v.dtype], _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return out


def km_update_slot(ring: torch.Tensor, src, dst, t, p_t: torch.Tensor,
                   g_t: torch.Tensor, eta: float, eta_k: float) -> None:
    """ring[dst] = ring[src] with column t updated, on a CUDA ring, in
    place; one launch, nothing allocated."""
    global launches
    name = "km_update_slot"
    dev = _build.require_cuda(name, ring=ring, p_t=p_t, g_t=g_t)
    src, dst, t = _build.km_update_slot_args(ring, src, dst, t, p_t, g_t)
    eta32 = _build.host_scalar("eta", eta)
    eta_k32 = _build.host_scalar("eta_k", eta_k)
    _, d, num_t = ring.shape
    if d == 0:
        return
    vector = num_t % 4 == 0 and ring.data_ptr() % 16 == 0
    fn = _build.function("km_update_slot_launch", _SLOT_ARGTYPES)
    err = fn(ring.data_ptr(), src, dst, t, d, num_t, p_t.data_ptr(),
             g_t.data_ptr(), eta32, eta_k32, int(vector), _build.stream(dev))
    _build.check(err, name)
    launches += 1
