"""CUDA kernel for the seeded-minibatch least-squares gradients (wrapper).

Port of `repro/kernels/lstsq_grad_sampled.py :: lstsq_grad_sampled`; the
kernel is `repro_torch/csrc/lstsq_grad_sampled.cu`.  For each event e of
a batch:

    G[e] = (n_t/bsz) * 2 X_S^T (X_S w_e - y_S),   bsz = min(batch_size, n_t)

with X = xs[tasks[e]], y = ys[tasks[e]] and row i in S iff its keep bit, a
local predicate over counter_hash(seed, i) and the event's scalar block
(seed, cut_h, cut_i, n_t), is set.  The blocks are planned on the host
(`ref.sample_scalars`).  `lstsq_grad_sampled_batch` computes B events in
one launch, reading the blocks from a (B, 4) uint32 tensor on the card;
`lstsq_grad_sampled` is one event, the same kernel with B = 1 and its
block passed by value.  No atomics: row e of a batched launch has the bits
of the single event's launch, on every call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_uint] * 4 + [ctypes.c_int] \
    + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_BATCH_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# The largest d the kernel takes (csrc: 4 x 8 float4 groups a thread x 8
# CTAs x 256 threads).
MAX_D = 65536


def lstsq_grad_sampled(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                       scalars, batch_size: int) -> torch.Tensor:
    """(d,) float32 minibatch gradient for contiguous float32 CUDA x (n, d),
    w (d,), y (n,); `scalars` is the event's host (seed, cut_h, cut_i, n_t).
    Only the kept rows of x are read."""
    global launches
    name = "lstsq_grad_sampled"
    dev = _build.require_cuda(name, x=x, w=w, y=y)
    _build.require_dtype(name, torch.float32, x=x, w=w, y=y)
    n, d = _build.lstsq_shapes(name, x, w, y)
    seed, cut_h, cut_i, n_t = _build.scalar_block(name, scalars)
    _check_sizes(name, d, batch_size)
    g = torch.empty((d,), dtype=torch.float32, device=dev)
    fn = _build.function("lstsq_grad_sampled_launch", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), seed, cut_h, cut_i,
             n_t, _clamp(batch_size), g.data_ptr(), n, d, _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return g


def lstsq_grad_sampled_batch(xs: torch.Tensor, ys: torch.Tensor,
                             tasks: torch.Tensor, w_rows: torch.Tensor,
                             scalars: torch.Tensor,
                             batch_size: int) -> torch.Tensor:
    """(B, d) float32 minibatch gradients of B events in one launch.

    xs (T, n, d) and ys (T, n) float32 are the problem's buffers, read in
    place; tasks (B,) int32 the events' task ids (one outside [0, T) picks
    its task by `ref.task_index`, the reference's dynamic index); w_rows
    (B, d) float32 the events' prox columns; scalars (B, 4) uint32 their
    scalar blocks.  All contiguous on one CUDA device.  Shapes, dtypes and sizes are checked
    before the device, so nothing is built for a call that cannot launch.
    """
    global launches
    name = "lstsq_grad_sampled_batch"
    _build.require_dtype(name, torch.float32, xs=xs, ys=ys, w_rows=w_rows)
    _build.require_dtype(name, torch.int32, tasks=tasks)
    _build.require_dtype(name, torch.uint32, scalars=scalars)
    if xs.dim() != 3 or tasks.dim() != 1:
        raise ValueError(f"{name}: xs must be (T, n, d) and tasks (B,); got "
                         f"{tuple(xs.shape)}, {tuple(tasks.shape)}")
    num_t, n, d = xs.shape
    b = tasks.shape[0]
    if ys.shape != (num_t, n) or w_rows.shape != (b, d) \
            or scalars.shape != (b, 4):
        raise ValueError(f"{name}: ys must be ({num_t}, {n}), w_rows "
                         f"({b}, {d}) and scalars ({b}, 4); got "
                         f"{tuple(ys.shape)}, {tuple(w_rows.shape)}, "
                         f"{tuple(scalars.shape)}")
    if b < 1:
        raise ValueError(f"{name}: the batch must hold an event, got B = 0")
    _check_sizes(name, d, batch_size)
    dev = _build.require_cuda(name, xs=xs, ys=ys, tasks=tasks, w_rows=w_rows,
                              scalars=scalars)
    g = torch.empty((b, d), dtype=torch.float32, device=dev)
    fn = _build.function("lstsq_grad_sampled_batch_launch", _BATCH_ARGTYPES)
    err = fn(xs.data_ptr(), ys.data_ptr(), tasks.data_ptr(),
             w_rows.data_ptr(), scalars.data_ptr(), _clamp(batch_size),
             g.data_ptr(), num_t, n, d, b, _build.stream(dev))
    _build.check(err, name)
    launches += 1
    return g


def _check_sizes(name: str, d: int, batch_size: int) -> None:
    if batch_size < 1:
        raise ValueError(f"{name}: batch_size must be >= 1, got {batch_size}")
    if d > MAX_D:
        raise ValueError(f"{name}: d must be <= {MAX_D}, got {d}")


def _clamp(batch_size: int) -> int:
    """batch_size as a C int: past 2^31 - 1 it saturates every block."""
    return min(int(batch_size), 2**31 - 1)
