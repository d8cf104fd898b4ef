"""CUDA kernels for flash attention (wrapper and route choice).

Port of `repro/kernels/flash_attention.py :: flash_attention`, generalized
to the model's `mha`.  It takes q (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd)
in the model's layout, float32 or bfloat16, with causal and sliding-window
masks, a key-count limit `kv_len`, a query offset and a logit softcap, and
accumulates in float32.  Three kernels compute that whole function; the
choice between them (`route`) is about speed only:

- `sm90` (`csrc/flash_attention_sm90.cu`): tensor cores (wgmma) fed by TMA,
  for bfloat16 with hd 64, 128 or 256 (the served prefill);
- `split` (`csrc/flash_decode.cu`): split-KV on the CUDA cores, for calls
  with at most 64 query rows a kv head (Sq * H / Hkv), float32 or bfloat16,
  hd a multiple of 8 (the served decode);
- `simt` (`csrc/flash_attention.cu`): float32 on the CUDA cores, for
  everything else (float32 prefill, hd not a multiple of 64).

Each route counts its own launches (`launches_sm90`, `launches_split`,
`launches_simt`); `launches` is their total.  A route that cannot take a
call, or fails to build or launch, raises: nothing gives way to another.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0
launches_sm90 = 0
launches_split = 0
launches_simt = 0
MAX_HEAD_DIM = 256         # the accumulator and the tiles are sized for it
ROUTES = ("sm90", "split", "simt")
SM90_HEAD_DIMS = (64, 128, 256)
SPLIT_MAX_ROWS = 64        # query rows a kv head that `split` takes
SPLIT_ROWS_PER_BLOCK = 8   # csrc/flash_decode.cu's MAX_ROWS
SPLIT_RUNS = 4             # csrc/flash_decode.cu's C_GROUPS (merge order)
SPLIT_MIN_CHUNK = 64       # fewest keys a split, where kv_len allows
SPLIT_BLOCKS_PER_SM = 2

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float] \
    + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
_SM90_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_float,
                                               ctypes.c_void_p]
_SPLIT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_float] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def softmax_scale(hd: int) -> float:
    """1 / sqrt(hd) rounded as the reference rounds it, in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def accepts(name: str, dtype: torch.dtype, sq: int, h: int, hkv: int,
            hd: int) -> bool:
    """Whether route `name` takes a call of this dtype and these shapes."""
    if name == "sm90":
        return dtype == torch.bfloat16 and hd in SM90_HEAD_DIMS
    if name == "split":
        return sq * (h // hkv) <= SPLIT_MAX_ROWS and hd % 8 == 0
    if name == "simt":
        return True
    raise ValueError(f"flash_attention: unknown route {name!r}; the routes "
                     f"are {ROUTES}")


def route(dtype: torch.dtype, b: int, sq: int, skv: int, h: int, hkv: int,
          hd: int, kv_len: int) -> str:
    """The fastest route that takes the call: `split` for few query rows a
    kv head (decode), else `sm90` for bfloat16 at hd 64/128/256 (prefill),
    else `simt`.  A pure function of host values; B, Skv and kv_len do not
    change the choice today (every route takes any of them)."""
    for name in ("split", "sm90"):
        if accepts(name, dtype, sq, h, hkv, hd):
            return name
    return "simt"


_choose = route            # `flash_attention`'s `route=` keyword shadows it


def split_plan(kv_len: int, groups: int, sm_count: int) -> tuple[int, int]:
    """(splits, chunk) of the split route: split s holds the keys
    [s * chunk, min((s + 1) * chunk, kv_len)).  `groups` is the number of
    blocks a split has besides (B * Hkv * row groups).  Aims at
    SPLIT_BLOCKS_PER_SM blocks an SM with chunks of at least
    SPLIT_MIN_CHUNK keys, rounded up to a multiple of 16; every split holds
    at least one key when kv_len > 0."""
    want = -(-SPLIT_BLOCKS_PER_SM * sm_count // max(groups, 1))
    chunk = max(SPLIT_MIN_CHUNK, -(-kv_len // want))
    chunk = -(-chunk // 16) * 16
    return max(1, -(-kv_len // chunk)), chunk


def split_groups(b: int, sq: int, h: int, hkv: int) -> int:
    """Blocks of the split route a split has: one per (batch, kv head,
    group of SPLIT_ROWS_PER_BLOCK query rows of the kv head)."""
    rows = sq * (h // hkv)
    return b * hkv * -(-rows // SPLIT_ROWS_PER_BLOCK)


def split_plan_for(q: torch.Tensor, k: torch.Tensor,
                   kv_len: int) -> tuple[int, int]:
    """(splits, chunk) that the split route takes for CUDA q (B, Sq, H,
    hd) and k (B, Skv, Hkv, hd) with `kv_len` valid keys, on q's card."""
    b, sq, h, _ = q.shape
    return split_plan(kv_len, split_groups(b, sq, h, k.shape[2]),
                      _build.sm_count(q.device))


def check_call(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, window, softcap, kv_len, **more):
    """The checked (B, Sq, Skv, H, Hkv, hd, window, cap, kv_len) of an
    attention call on q (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd) of one
    dtype of _DTYPES (and any `more` tensors of q's shape and dtype), as
    the kernels take them: window 0 and cap 0.0 where off, kv_len Skv by
    default.  Raises ValueError on anything a kernel does not take."""
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, *more.values())):
        raise ValueError(f"{name}: q, k, v{''.join(', ' + m for m in more)} "
                         f"must share one dtype of {list(_DTYPES)}; got "
                         + ", ".join(str(t.dtype) for t in
                                     (q, k, v, *more.values())))
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or any(t.shape != q.shape for t in more.values()):
        raise ValueError(f"{name} expects q{''.join(', ' + m for m in more)} "
                         f"(B, Sq, H, hd), k and v (B, Skv, Hkv, hd); got "
                         + ", ".join(str(tuple(t.shape)) for t in
                                     (q, k, v, *more.values())))
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
    return b, sq, skv, h, hkv, hd, window, cap, kv_len


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int | None = None,
                    softcap: float | None = None, q_offset: int = 0,
                    kv_len: int | None = None,
                    route: str | None = None) -> torch.Tensor:
    """(B, Sq, H, hd) attention output, in q's dtype, from contiguous CUDA
    q (B, Sq, H, hd) and k, v (B, Skv, Hkv, hd) of one dtype (float32 or
    bfloat16), with H a multiple of Hkv and hd <= 256.  `q_offset` is the
    position of q's first row, `kv_len` (default Skv) the number of valid
    keys; window and softcap are off when None.  All are host values.
    `route` forces one of ROUTES (default: `route(...)`'s choice); a
    route that does not take the call raises."""
    global launches, launches_sm90, launches_split, launches_simt
    name = "flash_attention"
    dev = _build.require_cuda(name, q=q, k=k, v=v)
    b, sq, skv, h, hkv, hd, window, cap, kv_len = check_call(
        name, q, k, v, window, softcap, kv_len)
    if route is None:
        route = _choose(q.dtype, b, sq, skv, h, hkv, hd, kv_len)
    elif not accepts(route, q.dtype, sq, h, hkv, hd):
        raise ValueError(f"{name}: route {route!r} does not take {q.dtype} "
                         f"with Sq {sq}, H {h}, Hkv {hkv}, hd {hd}")
    if route != "simt" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must start 16-byte aligned "
                         f"for the {route} route")
    out = torch.empty_like(q)
    scale, stream = softmax_scale(hd), _build.stream(dev)
    if route == "sm90":
        fn = _build.function("flash_attention_sm90_launch", _SM90_ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, skv, h, hkv, hd, int(causal), window, cap,
                 int(q_offset), kv_len, scale, stream)
        _build.check(err, f"{name} (sm90)")
        launches_sm90 += 1
    elif route == "split":
        rows = sq * (h // hkv)
        splits, chunk = split_plan_for(q, k, kv_len)
        # scratch, freed on return: the caching allocator hands the blocks
        # only to later work on this stream, which runs after the kernels
        part_ml = torch.empty((b, hkv, rows, splits, 2),
                              dtype=torch.float32, device=dev)
        part_acc = torch.empty((b, hkv, rows, splits, hd),
                               dtype=torch.float32, device=dev)
        fn = _build.function("flash_decode_launch", _SPLIT_ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 part_ml.data_ptr(), part_acc.data_ptr(), _DTYPES[q.dtype],
                 b, sq, skv, h, hkv, hd, int(causal), window, cap,
                 int(q_offset), kv_len, scale, splits, chunk, stream)
        _build.check(err, f"{name} (split)")
        launches_split += 1
    else:
        fn = _build.function("flash_attention_launch", _ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, sq, skv, h, hkv, hd, int(causal),
                 window, cap, int(q_offset), kv_len, scale, stream)
        _build.check(err, f"{name} (simt)")
        launches_simt += 1
    launches += 1
    return out


def reset_route_counts() -> None:
    global launches_sm90, launches_split, launches_simt
    launches_sm90 = launches_split = launches_simt = 0


def route_counts() -> dict[str, int]:
    return {"sm90": launches_sm90, "split": launches_split,
            "simt": launches_simt}
