"""CUDA kernel for the RWKV-6 WKV recurrence (wrapper).

Port of `repro/kernels/rwkv6_scan.py :: rwkv6_scan`, generalized to the
model's time mix; the kernel is `repro_torch/csrc/rwkv6_scan.cu`.  It takes
r, k, v (B, L, H, D) float32 or bfloat16 and w (B, L, H, D) float32 in the
model's layout, u (H, D) float32 and a state (B, H, D, D) float32, which it
reads and overwrites with the state after the last token.  Prefill (any L)
and decode (L 1) both launch it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0
HEAD_SIZES = (32, 64)      # the kernel is instantiated for these D

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """out (B, L, H, D) in r's dtype; `state` (B, H, D, D) is updated in
    place.  All are contiguous CUDA tensors on one device: r, k, v of one
    dtype (float32 or bfloat16); w, u and state float32 (a bfloat16 decay
    near 1 would round to 0.996 or 1.0)."""
    global launches
    name = "rwkv6_scan"
    dev = _build.require_cuda(name, r=r, k=k, v=v, w=w, u=u, state=state)
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"{name}: r, k, v must share one dtype of "
                         f"{list(_DTYPES)}; got {r.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    _build.require_dtype(name, torch.float32, w=w, u=u, state=state)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"{name} expects r, k, v, w of one shape "
                         f"(B, L, H, D); got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    b, ell, h, d = r.shape
    if u.shape != (h, d) or state.shape != (b, h, d, d):
        raise ValueError(f"{name}: u must be (H, D) = {(h, d)} and state "
                         f"(B, H, D, D) = {(b, h, d, d)}; got "
                         f"{tuple(u.shape)}, {tuple(state.shape)}")
    if d not in HEAD_SIZES or min(b, ell, h) < 1:
        raise ValueError(f"{name}: needs D in {HEAD_SIZES} and non-empty "
                         f"B, L, H; got B {b}, L {ell}, H {h}, D {d}")
    out = torch.empty_like(r)
    fn = _build.function("rwkv6_scan_launch", _ARGTYPES)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), state.data_ptr(), out.data_ptr(), _DTYPES[r.dtype],
             b, ell, h, d, _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return out
