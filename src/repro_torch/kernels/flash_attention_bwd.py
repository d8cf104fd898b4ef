"""CUDA kernels for the gradient of flash attention (wrapper and route
choice).

dq, dk and dv of the model's attention function
(`flash_attention.flash_attention`, `ref.mha_ref`), each summed in float32
and rounded once to the inputs' dtype, with no atomics: the result is the
same bits run to run.  Two routes compute that function; the choice
between them (`route`) is about speed only:

- `sm90` (`csrc/flash_attention_bwd_sm90.cu`): tensor cores (wgmma) fed by
  TMA, for bfloat16 with hd 64, 128 or 256 (the calls the forward's sm90
  route takes: the training path).  Three kernels: each row's log-sum-exp
  and D = rowsum(dO * O), then dq a query tile, then dk and dv a key tile.
  P and dS are rounded to bf16 where they feed a product; its plain
  version is `ref.mha_bwd_ref(..., p_dtype=torch.bfloat16)`;
- `simt` (`csrc/flash_attention_bwd.cu`): the CUDA cores in float32, for
  everything else (float32, other head dims); its plain version is
  `ref.mha_bwd_ref`.

Neither replaces a TPU kernel (the reference differentiates its jnp `mha`
and has no Pallas backward).  The inputs are the forward's: q (B, Sq, H,
hd), k, v (B, Skv, Hkv, hd), float32 or bfloat16, H a multiple of Hkv,
hd <= 256, with causal and sliding-window masks, a key count, a query
offset and a logit softcap, the scale rounded as
`flash_attention.softmax_scale` rounds it; plus the forward's output o and
its gradient do (B, Sq, H, hd).  Each route counts its own calls
(`launches_sm90`, `launches_simt`); `launches` is their total (one a
backward, whatever the kernels).  A route that cannot take a call, or
fails to build or launch, raises: nothing gives way to another.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (_DTYPES, SM90_HEAD_DIMS,
                                                 check_call, softmax_scale)

launches = 0
launches_sm90 = 0
launches_simt = 0
ROUTES = ("sm90", "simt")
SM90_ROWS = 128            # csrc/flash_attention_bwd_sm90.cu's ROWS

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float] \
    + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
_SM90_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_float,
                                               ctypes.c_void_p]


def accepts(name: str, dtype: torch.dtype, sq: int, h: int, hkv: int,
            hd: int) -> bool:
    """Whether route `name` takes a backward of this dtype and these
    shapes."""
    if name == "sm90":
        return dtype == torch.bfloat16 and hd in SM90_HEAD_DIMS
    if name == "simt":
        return True
    raise ValueError(f"flash_attention_bwd: unknown route {name!r}; the "
                     f"routes are {ROUTES}")


def route(dtype: torch.dtype, b: int, sq: int, skv: int, h: int, hkv: int,
          hd: int, kv_len: int) -> str:
    """`sm90` for bfloat16 at hd 64/128/256, else `simt`.  A pure function
    of host values; B, Sq, Skv, H, Hkv and kv_len do not change the choice
    today (both routes take any of them)."""
    return "sm90" if accepts("sm90", dtype, sq, h, hkv, hd) else "simt"


_choose = route        # `flash_attention_bwd`'s `route=` keyword shadows it


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                        window: int | None = None,
                        softcap: float | None = None, q_offset: int = 0,
                        kv_len: int | None = None, route: str | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each in its input's shape and dtype, from contiguous
    CUDA tensors of one dtype.  window, softcap, q_offset and kv_len are
    host values, as the forward takes them.  `route` forces one of ROUTES
    (default: `route(...)`'s choice); a route that does not take the call
    raises."""
    global launches, launches_sm90, launches_simt
    name = "flash_attention_bwd"
    b, sq, skv, h, hkv, hd, window, cap, kv_len = check_call(
        name, q, k, v, window, softcap, kv_len, o=o, do=do)
    if int(q_offset) < 0:
        raise ValueError(f"{name}: q_offset must be >= 0, got {q_offset}")
    if route is None:
        route = _choose(q.dtype, b, sq, skv, h, hkv, hd, kv_len)
    elif not accepts(route, q.dtype, sq, h, hkv, hd):
        raise ValueError(f"{name}: route {route!r} does not take {q.dtype} "
                         f"with hd {hd}")
    dev = _build.require_cuda(name, q=q, k=k, v=v, o=o, do=do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scale, stream = softmax_scale(hd), _build.stream(dev)
    if route == "sm90":
        if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
            raise ValueError(f"{name}: q, k, v, o and do must start 16-byte "
                             "aligned for the sm90 route")
        rows = -(-sq // SM90_ROWS) * SM90_ROWS
        # scratch, freed on return: later work on this stream runs after
        stats = torch.empty((2, b, h, rows), dtype=torch.float32, device=dev)
        fn = _build.function("flash_attention_bwd_sm90_launch",
                             _SM90_ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 stats[0].data_ptr(), stats[1].data_ptr(), b, sq, skv, h,
                 hkv, hd, int(causal), window, cap, int(q_offset), kv_len,
                 scale, stream)
        _build.check(err, f"{name} (sm90)")
        launches_sm90 += 1
    else:
        stats = torch.empty((2, b, h, sq), dtype=torch.float32, device=dev)
        fn = _build.function("flash_attention_bwd_launch", _ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 stats[0].data_ptr(), stats[1].data_ptr(), _DTYPES[q.dtype],
                 b, sq, skv, h, hkv, hd, int(causal), window, cap,
                 int(q_offset), kv_len, scale, stream)
        _build.check(err, f"{name} (simt)")
        launches_simt += 1
    launches += 1
    return dq, dk, dv


def reset_route_counts() -> None:
    global launches_sm90, launches_simt
    launches_sm90 = launches_simt = 0


def route_counts() -> dict[str, int]:
    return {"sm90": launches_sm90, "simt": launches_simt}
