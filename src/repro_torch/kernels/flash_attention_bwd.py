"""CUDA kernel for the gradient of flash attention (wrapper).

`csrc/flash_attention_bwd.cu` computes dq, dk and dv of the model's
attention function (`flash_attention.flash_attention`, `ref.mha_ref`) in
one call of three kernels: each row's log-sum-exp and D = rowsum(dO * O)
(the forward kernels keep no log-sum-exp), then dk and dv a key tile, then
dq a query tile, each in float32 and rounded once to the inputs' dtype.
No atomics: the result is the same bits run to run.  It replaces no TPU
kernel (the reference differentiates its jnp `mha` and has no Pallas
backward); its plain version is `ref.mha_bwd_ref`.

The inputs are the forward's: q (B, Sq, H, hd), k, v (B, Skv, Hkv, hd),
float32 or bfloat16, H a multiple of Hkv, hd <= 256, with causal and
sliding-window masks, a key count, a query offset and a logit softcap, the
scale rounded as `flash_attention.softmax_scale` rounds it; plus the
forward's output o and its gradient do (B, Sq, H, hd).  `launches` counts
its calls (one a backward, whatever the three kernels).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (_DTYPES, check_call,
                                                 softmax_scale)

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float] \
    + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                        window: int | None = None,
                        softcap: float | None = None, q_offset: int = 0,
                        kv_len: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each in its input's shape and dtype, from contiguous
    CUDA tensors of one dtype.  window, softcap, q_offset and kv_len are
    host values, as the forward takes them."""
    global launches
    name = "flash_attention_bwd"
    dev = _build.require_cuda(name, q=q, k=k, v=v, o=o, do=do)
    b, sq, skv, h, hkv, hd, window, cap, kv_len = check_call(
        name, q, k, v, window, softcap, kv_len, o=o, do=do)
    if int(q_offset) < 0:
        raise ValueError(f"{name}: q_offset must be >= 0, got {q_offset}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # scratch, freed on return: later work on this stream runs after
    stats = torch.empty((2, b, h, sq), dtype=torch.float32, device=dev)
    fn = _build.function("flash_attention_bwd_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             stats[0].data_ptr(), stats[1].data_ptr(), _DTYPES[q.dtype], b,
             sq, skv, h, hkv, hd, int(causal), window, cap, int(q_offset),
             kv_len, softmax_scale(hd), _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return dq, dk, dv
