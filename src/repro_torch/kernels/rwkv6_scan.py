"""CUDA kernels for the RWKV-6 WKV recurrence (wrapper and route choice).

Port of `repro/kernels/rwkv6_scan.py :: rwkv6_scan`, generalized to the
model's time mix.  It takes r, k, v (B, L, H, D) float32 or bfloat16 and w
(B, L, H, D) float32 in the model's layout, u (H, D) float32 and a state
(B, H, D, D) float32, which it reads and overwrites with the state after
the last token.  Two kernels compute that whole function; the choice
between them (`route`) is about speed only:

- `chunked` (`csrc/rwkv6_chunked.cu`): sub-chunks of 16 tokens on the
  tensor cores (TF32 mma), for bfloat16 r, k, v at D 64 (any L; `route`
  sends it L of at least CHUNKED_MIN_LEN: the served prefill);
- `recurrent` (`csrc/rwkv6_scan.cu`): the token-by-token recurrence on the
  CUDA cores, its state bitwise `ref.wkv_ref`'s, for everything else
  (decode, float32, D 32, short L).

Each route counts its own launches (`launches_chunked`,
`launches_recurrent`); `launches` is their total.  A route that cannot
take a call, or fails to build or launch, raises: nothing gives way to
another.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0
launches_chunked = 0
launches_recurrent = 0
ROUTES = ("chunked", "recurrent")
HEAD_SIZES = (32, 64)      # the recurrent kernel is instantiated for these D
CHUNKED_HEAD_SIZES = (64,)
# Fewest tokens `route` sends to the chunked route: phase 12 of
# chip_smoke.py times both routes at B 2, H 40, L 1 to 256; on an H100
# 80GB HBM3 at 700 W chunked was slower at L 8 (6.46 against 6.08 us) and
# faster from L 16 (6.54 against 9.24).
CHUNKED_MIN_LEN = 16
CHUNKED_THREADS = 256      # csrc/rwkv6_chunked.cu's THREADS: 8 warps
CHUNKED_CHUNK = 64         # its CHUNK: tokens staged a round
CHUNKED_SUB = 16           # its SUB: tokens a state step
CHUNKED_BLOCK = 4          # its BLK: tokens a score block
CHUNKED_PRODUCT_WARPS = 4  # its PW: warps that hold the state
CHUNKED_STAGES = 3         # its STAGES: chunks in the ring

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_CHUNKED_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]


class Plan(NamedTuple):
    """Launch plan of the chunked route: one block for each (b, h), whose
    first `product_warps` warps each hold the state of one tile of value
    columns and all D key channels: warp w the columns [w * value_tile,
    +value_tile)."""
    grid: int              # blocks: B * H
    threads: int
    chunk: int             # tokens staged a round
    sub: int               # tokens a state step
    product_warps: int
    value_tile: int        # value columns a product warp
    smem: int              # dynamic shared bytes a block


def plan(b: int, ell: int, h: int, d: int) -> Plan:
    """The chunked route's launch plan (csrc/rwkv6_chunked.cu's layout):
    a ring of CHUNKED_STAGES staged chunks (r, k, v in bf16 rows padded to
    72, w in float32), r * E, k * F and the score queries X (float32 rows
    of 72), each sub-chunk's score keys Y (4 + 8 + 12 rows), its 16 x 20
    scores and its decays E."""
    if d not in CHUNKED_HEAD_SIZES or min(b, ell, h) < 1:
        raise ValueError(f"rwkv6_scan: no chunked plan for B {b}, L {ell}, "
                         f"H {h}, D {d}")
    c, s, stride = CHUNKED_CHUNK, CHUNKED_SUB, d + 8
    subs, blocks = c // s, s // CHUNKED_BLOCK
    y_rows = CHUNKED_BLOCK * blocks * (blocks - 1) // 2
    stage = 3 * c * stride * 2 + c * d * 4
    smem = CHUNKED_STAGES * stage + 4 * (
        3 * c * stride + subs * y_rows * stride + subs * s * (s + 4)
        + subs * d)
    return Plan(grid=b * h, threads=CHUNKED_THREADS, chunk=c, sub=s,
                product_warps=CHUNKED_PRODUCT_WARPS,
                value_tile=d // CHUNKED_PRODUCT_WARPS, smem=smem)


def warp_tiles(pl: Plan, d: int) -> np.ndarray:
    """(blocks * product warps, 5) int64 array of each product warp's
    state tile: (block, value columns [c0, c1), key channels [i0, i1)), as
    the kernel derives it from blockIdx and the warp index."""
    blk, wp = np.meshgrid(np.arange(pl.grid), np.arange(pl.product_warps),
                          indexing="ij")
    blk, wp = blk.ravel(), wp.ravel()
    c0 = wp * pl.value_tile
    zeros = np.zeros_like(c0)
    return np.stack([blk, c0, c0 + pl.value_tile, zeros, zeros + d], axis=1)


def accepts(name: str, dtype: torch.dtype, d: int) -> bool:
    """Whether route `name` takes a call of this dtype and D (both take
    any L >= 1)."""
    if name == "chunked":
        return dtype == torch.bfloat16 and d in CHUNKED_HEAD_SIZES
    if name == "recurrent":
        return dtype in _DTYPES and d in HEAD_SIZES
    raise ValueError(f"rwkv6_scan: unknown route {name!r}; the routes are "
                     f"{ROUTES}")


def route(dtype: torch.dtype, b: int, ell: int, h: int, d: int) -> str:
    """The fastest route that takes the call: `chunked` for bfloat16 at D
    64 and L >= CHUNKED_MIN_LEN (prefill), else `recurrent`.  A pure
    function of host values; B and H do not change the choice today."""
    return "chunked" if accepts("chunked", dtype, d) \
        and ell >= CHUNKED_MIN_LEN else "recurrent"


_choose = route            # `wkv`'s `route=` keyword shadows it


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor, *,
        route: str | None = None) -> torch.Tensor:
    """out (B, L, H, D) in r's dtype; `state` (B, H, D, D) is updated in
    place.  All are contiguous CUDA tensors on one device: r, k, v of one
    dtype (float32 or bfloat16); w, u and state float32 (a bfloat16 decay
    near 1 would round to 0.996 or 1.0).  `route` forces one of ROUTES
    (default: `route(...)`'s choice); a route that does not take the call
    raises."""
    global launches, launches_chunked, launches_recurrent
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
    if route is None:
        route = _choose(r.dtype, b, ell, h, d)
    elif not accepts(route, r.dtype, d):
        raise ValueError(f"{name}: route {route!r} does not take {r.dtype} "
                         f"at D {d}")
    out = torch.empty_like(r)
    if route == "chunked":
        if any(t.data_ptr() % 16 for t in (r, k, v, w, u)):
            raise ValueError(f"{name}: r, k, v, w and u must start 16-byte "
                             "aligned for the chunked route")
        pl = plan(b, ell, h, d)
        fn = _build.function("rwkv6_chunked_launch", _CHUNKED_ARGTYPES)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state.data_ptr(), out.data_ptr(), b, ell, h,
                 d, pl.grid, pl.threads, pl.smem, _build.stream(dev))
        _build.check(err, f"{name} (chunked)")
        launches_chunked += 1
    else:
        fn = _build.function("rwkv6_scan_launch", _ARGTYPES)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state.data_ptr(), out.data_ptr(),
                 _DTYPES[r.dtype], b, ell, h, d, _build.stream(dev))
        _build.check(err, f"{name} (recurrent)")
        launches_recurrent += 1
    launches += 1
    return out


def reset_route_counts() -> None:
    global launches_chunked, launches_recurrent
    launches_chunked = launches_recurrent = 0


def route_counts() -> dict[str, int]:
    return {"chunked": launches_chunked, "recurrent": launches_recurrent}
