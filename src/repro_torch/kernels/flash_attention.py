"""CUDA kernel for flash attention (wrapper).

Port of `repro/kernels/flash_attention.py :: flash_attention`, generalized
to the model's `mha`; the kernel is `repro_torch/csrc/flash_attention.cu`.
It takes q (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd) in the model's layout,
float32 or bfloat16, with causal and sliding-window masks, a key-count
limit `kv_len`, a query offset and a logit softcap, and accumulates in
float32.  Prefill and decode both launch it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0
MAX_HEAD_DIM = 256         # the accumulator and the tiles are sized for it

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float] \
    + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]


def softmax_scale(hd: int) -> float:
    """1 / sqrt(hd) rounded as the reference rounds it, in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int | None = None,
                    softcap: float | None = None, q_offset: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """(B, Sq, H, hd) attention output, in q's dtype, from contiguous CUDA
    q (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd) of one dtype (float32 or
    bfloat16), with H a multiple of Hkv and hd <= 256.  `q_offset` is the
    position of q's first row, `kv_len` (default Skv) the number of valid
    keys; window and softcap are off when None.  All are host values."""
    global launches
    name = "flash_attention"
    dev = _build.require_cuda(name, q=q, k=k, v=v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share one dtype of "
                         f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name} expects q (B, Sq, H, hd), k and v "
                         f"(B, Skv, Hkv, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if h % hkv or not 0 < hd <= MAX_HEAD_DIM or min(b, sq, skv) < 1:
        raise ValueError(f"{name}: needs H % Hkv == 0, 0 < hd <= "
                         f"{MAX_HEAD_DIM} and non-empty B, Sq, Skv; got "
                         f"B {b}, Sq {sq}, Skv {skv}, H {h}, Hkv {hkv}, "
                         f"hd {hd}")
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"{name}: kv_len must lie in [0, {skv}], got "
                         f"{kv_len}")
    if window is not None and int(window) < 1:
        raise ValueError(f"{name}: window must be positive, got {window}")
    window = 0 if window is None else int(window)
    cap = 0.0 if softcap is None else _build.host_scalar(name, softcap)
    if softcap is not None and not cap > 0:
        raise ValueError(f"{name}: softcap must be positive, got {cap}")
    out = torch.empty_like(q)
    fn = _build.function("flash_attention_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], b, sq, skv, h, hkv, hd, int(causal), window,
             cap, int(q_offset), kv_len, softmax_scale(hd),
             _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return out
