"""CUDA kernel for the unmaterialized Gaussian sketch W @ Omega (wrapper).

Port of `repro/kernels/gauss_sketch.py :: gauss_sketch`; the kernel is
`repro_torch/csrc/gauss_sketch.cu`.  Omega's entry (r, c) is the
Box-Muller normal of `ref.gauss_from_counters(seed, (row_offset + r)*p + c)`,
generated in shared memory and never written to device memory.  `plan`
is the kernel's launch plan, a pure function of the shapes.
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
COLS = 8                   # C: the columns of Omega a block generates
ROWS_PER_THREAD = (1, 2, 3, 6)   # the kernel's instances R
CHUNK = 128                # columns of W a block stages at once
HELD_BUDGET = 168          # values a thread may hold (of 255 registers)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint] \
    + [ctypes.c_int] * 8 + [ctypes.c_void_p]


class Plan(NamedTuple):
    """Launch plan: block (x, y) owns the output rows [x * rows_per_block,
    ...) and columns [y * COLS, ...), clipped to (d, p); it stages W in
    chunks of CHUNK columns and generates the (t, COLS) slice of Omega its
    columns need."""
    rows_per_thread: int   # R: lane l owns rows l + 32 r, r < R
    grid: tuple[int, int]
    smem: int              # dynamic shared bytes a block
    held_values: int       # values a thread holds: R*C sums, this quad's
    #                        and the next's W (8R) and Omega (8C); the
    #                        compiler's register count is ptxas's report

    @property
    def rows_per_block(self) -> int:
        return 32 * self.rows_per_thread


def plan(d: int, t: int, p: int, sm_count: int) -> Plan:
    """The launch plan of a (d, t) @ (t, p) sketch on a card of `sm_count`
    SMs: COLS columns a block (each block generates only its columns of
    Omega), then the most rows a lane whose blocks still number at least
    90 % of the SMs (the fewest blocks, so the fewest normals, that fill
    the card), else one row a lane."""
    if d < 0 or t < 0 or p < 1 or sm_count < 1:
        raise ValueError(f"gauss_sketch: no plan for d={d}, t={t}, p={p} "
                         f"on {sm_count} SMs")
    grid_y = -(-p // COLS)
    fill = sm_count * 9 // 10
    r = next((r for r in sorted(ROWS_PER_THREAD, reverse=True)
              if -(-d // (32 * r)) * grid_y >= fill), 1)
    rows = 32 * r
    stage = CHUNK * (rows + COLS)      # a chunk of W and of Omega
    partials = WARPS * rows * (COLS + 1)
    return Plan(rows_per_thread=r, grid=(-(-d // rows), grid_y),
                smem=1024 + 4 * max(stage, partials),   # + swizzle alignment
                held_values=r * COLS + 8 * r + 8 * COLS)


def block_tiles(pl: Plan, d: int, p: int) -> np.ndarray:
    """(blocks, 4) int64 array of each block's output tile [r0, r1) x
    [c0, c1), as the kernel derives it from blockIdx."""
    gx, gy = pl.grid
    bx, by = np.meshgrid(np.arange(gx), np.arange(gy), indexing="ij")
    r0, c0 = bx.ravel() * pl.rows_per_block, by.ravel() * COLS
    return np.stack([r0, np.minimum(r0 + pl.rows_per_block, d),
                     c0, np.minimum(c0 + COLS, p)], axis=1)


def gauss_sketch(w: torch.Tensor, seed: int, row_offset: int,
                 p: int) -> torch.Tensor:
    """(d, p) float32 sketch of a contiguous float32 (d, t) CUDA tensor."""
    global launches
    dev = _build.require_cuda("gauss_sketch", w=w)
    _build.require_dtype("gauss_sketch", torch.float32, w=w)
    if w.dim() != 2:
        raise ValueError(f"gauss_sketch expects w as (d, t), got "
                         f"{tuple(w.shape)}")
    d, tt = w.shape
    pl = plan(d, tt, p, _build.sm_count(dev))
    vec = int(tt % 4 == 0 and w.data_ptr() % 16 == 0)
    out = torch.empty((d, p), dtype=torch.float32, device=dev)
    fn = _build.function("gauss_sketch_launch", _ARGTYPES)
    err = fn(w.data_ptr(), out.data_ptr(), int(seed) & 0xFFFFFFFF,
             int(row_offset) & 0xFFFFFFFF, d, tt, p, pl.rows_per_thread,
             *pl.grid, pl.smem, vec, _build.stream(dev))
    _build.check(err, "gauss_sketch")
    launches += 1
    return out
