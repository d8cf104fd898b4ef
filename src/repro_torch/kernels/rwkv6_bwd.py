"""CUDA kernel for the gradient of the RWKV-6 WKV recurrence (wrapper).

dr, dk, dv, dw and du of the model's WKV from a zero state
(`rwkv6_scan.wkv`, `ref.wkv_ref`), given the output's gradient do:
`csrc/rwkv6_bwd.cu`, the exact token-by-token gradient on the CUDA cores,
every sum in float32, dr, dk and dv rounded once to r's dtype, no atomics
(two launches give the same bits).  It replaces no TPU kernel: the
reference differentiates its jnp `_wkv_chunked` and has no Pallas
backward.  Its plain versions are `ref.wkv_bwd_exact_ref` (the same
formulas in PyTorch) and `ref.wkv_bwd_ref` (autograd through the chunked
form, the reference's order of sums and the CPU path).

One route, `recurrent`; `route=` takes only it and raises on anything
else.  A call the kernel cannot take raises: there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0
ROUTES = ("recurrent",)
HEAD_SIZES = (32, 64)      # the kernel is instantiated for these D
CKPT_EVERY = 8             # csrc/rwkv6_bwd.cu's SUB: tokens a checkpoint

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def scratch_shapes(b: int, ell: int, h: int, d: int) -> dict:
    """The float32 scratch a launch takes: each (b, h)'s state every
    CKPT_EVERY tokens, and du's per-batch partial sums."""
    return {"ckpt": (b * h, -(-ell // CKPT_EVERY), d, d),
            "du_part": (b, h, d)}


def wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, do: torch.Tensor, *,
            route: str | None = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor]:
    """(dr, dk, dv, dw, du) of out = WKV(r, k, v, w, u) from a zero state.
    r, k, v, do (B, L, H, D) of one dtype (float32 or bfloat16), w (B, L,
    H, D) and u (H, D) float32, all contiguous CUDA tensors on one device;
    D 32 or 64.  dr, dk, dv come in r's dtype, dw and du in float32."""
    global launches
    name = "rwkv6_bwd"
    if route is not None and route not in ROUTES:
        raise ValueError(f"{name}: unknown route {route!r}; the routes are "
                         f"{ROUTES}")
    dev = _build.require_cuda(name, r=r, k=k, v=v, w=w, u=u, do=do)
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, do)):
        raise ValueError(f"{name}: r, k, v, do must share one dtype of "
                         f"{list(_DTYPES)}; got {r.dtype}, {k.dtype}, "
                         f"{v.dtype}, {do.dtype}")
    _build.require_dtype(name, torch.float32, w=w, u=u)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w, do)):
        raise ValueError(f"{name} expects r, k, v, w, do of one shape "
                         f"(B, L, H, D); got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}, {tuple(do.shape)}")
    b, ell, h, d = r.shape
    if u.shape != (h, d):
        raise ValueError(f"{name}: u must be (H, D) = {(h, d)}; got "
                         f"{tuple(u.shape)}")
    if d not in HEAD_SIZES or min(b, ell, h) < 1:
        raise ValueError(f"{name}: needs D in {HEAD_SIZES} and non-empty "
                         f"B, L, H; got B {b}, L {ell}, H {h}, D {d}")
    if any(t.data_ptr() % 16 for t in (r, k, v, w, do)):
        raise ValueError(f"{name}: r, k, v, w and do must start 16-byte "
                         "aligned")
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty_like(u)
    shapes = scratch_shapes(b, ell, h, d)
    # scratch, freed on return: later work on this stream runs after
    ckpt = torch.empty(shapes["ckpt"], dtype=torch.float32, device=dev)
    du_part = torch.empty(shapes["du_part"], dtype=torch.float32, device=dev)
    fn = _build.function("rwkv6_bwd_launch", _ARGTYPES)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), do.data_ptr(), dr.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), dw.data_ptr(), du.data_ptr(), du_part.data_ptr(),
             ckpt.data_ptr(), _DTYPES[r.dtype], b, ell, h, d,
             _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return dr, dk, dv, dw, du
