"""CUDA kernel for the thresholded low-rank SVT apply (wrapper).

Port of `repro/kernels/svt_reconstruct.py :: svt_reconstruct`; the kernel
is `repro_torch/csrc/svt_reconstruct.cu`: (QU * sigma) @ V^T with the
sigma scale applied on the load of QU.  `plan` is the kernel's launch
plan, a pure function of the shapes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

launches = 0

THREADS = 256
WARPS = THREADS // 32
COL_TILE = 128             # columns a block: 32 lanes x 4
P_CHUNKS = (4, 8, 16, 24, 32)   # the kernel's p chunks PC (template instances)
MAX_ROWS_PER_WARP = 16
HELD_BUDGET = 160          # values a thread may hold (of 255 registers)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


class Plan(NamedTuple):
    """Launch plan: block (x, y) owns the output rows [x * rows_per_block,
    ...) and columns [y * COL_TILE, ...), clipped to (d, m); warp w takes
    the block's rows w, w + WARPS, ...; lane l the tile's columns 4l..4l+3."""
    p_chunk: int           # PC: V^T rows held in registers at once
    rows_per_block: int
    grid: tuple[int, int]
    smem: int              # dynamic shared bytes a block
    held_values: int       # values a thread holds: 4 PC of V^T, 16 sums
    #                        (four rows), a float4 of QU; the compiler's
    #                        register count is ptxas's report


def plan(d: int, p: int, m: int, sm_count: int) -> Plan:
    """The launch plan of (d, p) @ (p, m) on a card of `sm_count` SMs: the
    smallest chunk PC >= p (32, in chunks, above), and rows a block so
    that the blocks number about one for each SM, at most
    MAX_ROWS_PER_WARP rows a warp."""
    if d < 0 or m < 0 or p < 1 or sm_count < 1:
        raise ValueError(f"svt_reconstruct: no plan for d={d}, p={p}, m={m} "
                         f"on {sm_count} SMs")
    pc = next((c for c in P_CHUNKS if c >= p), P_CHUNKS[-1])
    grid_y = -(-m // COL_TILE)
    per_warp = -(-d * grid_y // (sm_count * WARPS))
    rows = WARPS * min(max(per_warp, 1), MAX_ROWS_PER_WARP)
    return Plan(p_chunk=pc, rows_per_block=rows,
                grid=(-(-d // rows), grid_y),
                smem=4 * (pc * COL_TILE + rows * pc + pc),
                held_values=4 * pc + 20)


def block_tiles(pl: Plan, d: int, m: int) -> np.ndarray:
    """(blocks, 4) int64 array of each block's output tile [r0, r1) x
    [c0, c1), as the kernel derives it from blockIdx."""
    gx, gy = pl.grid
    bx, by = np.meshgrid(np.arange(gx), np.arange(gy), indexing="ij")
    r0, c0 = bx.ravel() * pl.rows_per_block, by.ravel() * COL_TILE
    return np.stack([r0, np.minimum(r0 + pl.rows_per_block, d),
                     c0, np.minimum(c0 + COL_TILE, m)], axis=1)


def svt_reconstruct(qu: torch.Tensor, s: torch.Tensor,
                    vt: torch.Tensor) -> torch.Tensor:
    """(d, m) float32 from contiguous float32 CUDA qu (d, p), s (p,),
    vt (p, m)."""
    global launches
    name = "svt_reconstruct"
    dev = _build.require_cuda(name, qu=qu, s=s, vt=vt)
    _build.require_dtype(name, torch.float32, qu=qu, s=s, vt=vt)
    if qu.dim() != 2 or vt.dim() != 2 or qu.shape[1] != vt.shape[0] \
            or s.shape != (qu.shape[1],):
        raise ValueError(f"{name} expects qu (d, p), s (p,), vt (p, m); got "
                         f"{tuple(qu.shape)}, {tuple(s.shape)}, "
                         f"{tuple(vt.shape)}")
    d, p = qu.shape
    m = vt.shape[1]
    pl = plan(d, p, m, _build.sm_count(dev))
    out = torch.empty((d, m), dtype=torch.float32, device=dev)
    vec_cols = int(m % 4 == 0 and vt.data_ptr() % 16 == 0
                   and out.data_ptr() % 16 == 0)
    vec_rows = int(p % 4 == 0 and qu.data_ptr() % 16 == 0)
    fn = _build.function("svt_reconstruct_launch", _ARGTYPES)
    err = fn(qu.data_ptr(), s.data_ptr(), vt.data_ptr(), out.data_ptr(),
             d, p, m, pl.p_chunk, pl.rows_per_block, *pl.grid, pl.smem,
             vec_cols, vec_rows, _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return out
