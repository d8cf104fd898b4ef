"""CUDA kernels for the gradient of the RWKV-6 WKV recurrence (wrapper and
route choice).

dr, dk, dv, dw and du of the model's WKV from a zero state
(`rwkv6_scan.wkv`, `ref.wkv_ref`), given the output's gradient do, every
sum in float32, dr, dk and dv rounded once to r's dtype, no atomics (two
launches give the same bits).  It replaces no TPU kernel: the reference
differentiates its jnp `_wkv_chunked` and has no Pallas backward.  Two
kernels compute that whole function; the choice between them (`route`) is
about speed only:

- `chunked` (`csrc/rwkv6_bwd_chunked.cu`): the states at 64-token chunk
  boundaries in one launch, then a block a (b, h, chunk) in sub-chunks of
  16 tokens on the tensor cores (TF32 mma), for bfloat16 at D 64 (any L;
  `route` sends it L of at least CHUNKED_MIN_LEN: every training call).
  Plain version `ref.wkv_bwd_subchunk_ref`;
- `recurrent` (`csrc/rwkv6_bwd.cu`): the exact token-by-token gradient on
  the CUDA cores, for everything else (float32, D 32, short L).  Plain
  version `ref.wkv_bwd_exact_ref`.

`ref.wkv_bwd_ref` (autograd through the chunked form, the reference's
order of sums) is the CPU path.  Each route counts its own launches
(`launches_chunked`, `launches_recurrent`); `launches` is their total.  A
route that cannot take a call, or fails to build or launch, raises:
nothing gives way to another.
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
CKPT_EVERY = 8             # csrc/rwkv6_bwd.cu's SUB: tokens a checkpoint
# Fewest tokens `route` sends to the chunked route (phase 12 of
# chip_smoke.py times both routes at B 2, H 40 over L 1 to 256).
CHUNKED_MIN_LEN = 16
CHUNKED_THREADS = 256      # csrc/rwkv6_bwd_chunked.cu's THREADS: 8 warps
CHUNKED_CHUNK = 64         # its CHUNK: tokens between stored states
CHUNKED_SUB = 16           # its SUB: tokens a state step inside a chunk

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_CHUNKED_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p]


class Plan(NamedTuple):
    """Launch plan of the chunked route: `states_grid` blocks (one a
    direction and (b, h): block n < B H walks (b, h) = divmod(n, H)
    forwards for the state, block B H + n backwards for its gradient),
    then `chunk_grid` blocks, block n taking chunk n % n_chunks of (b, h) =
    divmod(n // n_chunks, H); all of `threads` threads."""
    states_grid: int       # 2 B H
    chunk_grid: int        # B H ceil(L / chunk)
    threads: int
    chunk: int             # tokens between stored states
    sub: int               # tokens a state step inside a chunk
    scratch_bytes: int     # float32 states and du's per-chunk sums
    states_smem: int       # dynamic shared bytes of a states block
    smem: int              # dynamic shared bytes of a chunk block


def plan(b: int, ell: int, h: int, d: int) -> Plan:
    """The chunked route's launch plan (csrc/rwkv6_bwd_chunked.cu's
    layout).  A states block stages two chunks of its two bf16 operands
    (rows padded to 72) and w, and holds the scaled operand (float32 rows
    of 72), the chunk's decay and each 16-token run's.  A chunk block
    holds the chunk's r, k, v, do (bf16 rows of 72) and w, E (float32
    rows of 72), each sub-chunk's E, its four G's and two S buffers (rows
    of 72), and one sub-chunk's working rows: X (then half of dw), k F, S
    do, G v and dr's and dk's across-block sums (16 rows of 72 each), Xt
    and Y (24 rows of 72), dA and A (16 x 20), dA by Y and Xt row (16 x
    28), rowsum(G * S) and u."""
    if d not in CHUNKED_HEAD_SIZES or min(b, ell, h) < 1:
        raise ValueError(f"rwkv6_bwd: no chunked plan for B {b}, L {ell}, "
                         f"H {h}, D {d}")
    c, s, stride = CHUNKED_CHUNK, CHUNKED_SUB, d + 8
    nc = -(-ell // c)
    y_rows = 24
    states_smem = 2 * (2 * c * stride * 2 + c * d * 4) + c * stride * 4 \
        + d * 4 + (c // s) * d * 4
    nsub = c // s
    smem = (4 * c * stride * 2 + c * d * 4 + c * stride * 4 + nsub * d * 4
            + nsub * d * stride * 4 + 2 * d * stride * 4
            + 4 * (6 * s * stride + 2 * y_rows * stride + 2 * s * (s + 4)
                   + 2 * s * (y_rows + 4) + 2 * d))
    scratch = 4 * (2 * b * h * nc * d * d + b * h * nc * d)
    return Plan(states_grid=2 * b * h, chunk_grid=b * h * nc,
                threads=CHUNKED_THREADS, chunk=c, sub=s,
                scratch_bytes=scratch, states_smem=states_smem, smem=smem)


def block_chunks(pl: Plan, h: int) -> np.ndarray:
    """(chunk_grid, 4) int64 array of each chunk block's (b, h, chunk,
    first token), as the kernel derives them from blockIdx."""
    n = np.arange(pl.chunk_grid)
    nc = pl.chunk_grid // (pl.states_grid // 2)
    bh, c = np.divmod(n, nc)
    b, hh = np.divmod(bh, h)
    return np.stack([b, hh, c, c * pl.chunk], axis=1)


def scratch_shapes(b: int, ell: int, h: int, d: int) -> dict:
    """The float32 scratch a `recurrent` launch takes: each (b, h)'s state
    every CKPT_EVERY tokens, and du's per-batch partial sums."""
    return {"ckpt": (b * h, -(-ell // CKPT_EVERY), d, d),
            "du_part": (b, h, d)}


def chunked_scratch_shapes(b: int, ell: int, h: int, d: int) -> dict:
    """The float32 scratch a `chunked` launch takes: the state before each
    chunk and its gradient after it, and du's per-chunk partial sums."""
    nc = -(-ell // CHUNKED_CHUNK)
    return {"states": (2, b * h, nc, d, d), "du_part": (b, h, nc, d)}


def accepts(name: str, dtype: torch.dtype, d: int) -> bool:
    """Whether route `name` takes a call of this dtype and D (both take
    any L >= 1)."""
    if name == "chunked":
        return dtype == torch.bfloat16 and d in CHUNKED_HEAD_SIZES
    if name == "recurrent":
        return dtype in _DTYPES and d in HEAD_SIZES
    raise ValueError(f"rwkv6_bwd: unknown route {name!r}; the routes are "
                     f"{ROUTES}")


def route(dtype: torch.dtype, ell: int, d: int) -> str:
    """The fastest route that takes the call: `chunked` for bfloat16 at D
    64 and L >= CHUNKED_MIN_LEN, else `recurrent`.  A pure function of
    host values."""
    return "chunked" if accepts("chunked", dtype, d) \
        and ell >= CHUNKED_MIN_LEN else "recurrent"


_choose = route            # `wkv_bwd`'s `route=` keyword shadows it


def wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, do: torch.Tensor, *,
            route: str | None = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor]:
    """(dr, dk, dv, dw, du) of out = WKV(r, k, v, w, u) from a zero state.
    r, k, v, do (B, L, H, D) of one dtype (float32 or bfloat16), w (B, L,
    H, D) and u (H, D) float32, all contiguous CUDA tensors on one device;
    D 32 or 64.  dr, dk, dv come in r's dtype, dw and du in float32.
    `route` forces one of ROUTES (default: `route(...)`'s choice); a route
    that does not take the call raises."""
    global launches, launches_chunked, launches_recurrent
    name = "rwkv6_bwd"
    if route is not None and not accepts(route, r.dtype, r.shape[-1]):
        raise ValueError(f"{name}: route {route!r} does not take {r.dtype} "
                         f"at D {r.shape[-1]}")
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
    if route is None:
        route = _choose(r.dtype, ell, d)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty_like(u)
    # scratch, freed on return: later work on this stream runs after
    if route == "chunked":
        shapes = chunked_scratch_shapes(b, ell, h, d)
        states = torch.empty(shapes["states"], dtype=torch.float32,
                             device=dev)
        du_part = torch.empty(shapes["du_part"], dtype=torch.float32,
                              device=dev)
        pl = plan(b, ell, h, d)
        fn = _build.function("rwkv6_bwd_chunked_launch", _CHUNKED_ARGTYPES)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), do.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                 du_part.data_ptr(), states.data_ptr(), b, ell, h, d,
                 pl.states_grid, pl.chunk_grid, pl.threads, pl.states_smem,
                 pl.smem, _build.stream(dev))
        _build.check(err, f"{name} (chunked)")
        launches_chunked += 1
    else:
        shapes = scratch_shapes(b, ell, h, d)
        ckpt = torch.empty(shapes["ckpt"], dtype=torch.float32, device=dev)
        du_part = torch.empty(shapes["du_part"], dtype=torch.float32,
                              device=dev)
        fn = _build.function("rwkv6_bwd_launch", _ARGTYPES)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), do.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                 du_part.data_ptr(), ckpt.data_ptr(), _DTYPES[r.dtype], b,
                 ell, h, d, _build.stream(dev))
        _build.check(err, f"{name} (recurrent)")
        launches_recurrent += 1
    launches += 1
    return dr, dk, dv, dw, du


def reset_route_counts() -> None:
    global launches_chunked, launches_recurrent
    launches_chunked = launches_recurrent = 0


def route_counts() -> dict[str, int]:
    return {"chunked": launches_chunked, "recurrent": launches_recurrent}
