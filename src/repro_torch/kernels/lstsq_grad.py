"""CUDA kernel for the full least-squares task gradients (wrapper).

Port of `repro/kernels/lstsq_grad.py :: lstsq_grad`; the kernel is
`repro_torch/csrc/lstsq_grad.cu`.  For each event e of a batch:

    G[e] = 2 X_t^T (X_t w_e - y_t),   t = tasks[e],   rows >= n_t masked

with X_t = xs[t], y_t = ys[t] and n_t the task's row count, read on the
card.  One launch computes any number of events: `lstsq_grad_batch` a
batch step's B (or every task of FISTA's full gradient), `lstsq_grad_task`
one event on a task picked by a host id (the delta and dense engines),
`lstsq_grad` one (n, d) buffer with a host row count.  A cluster of 8 CTAs
takes GROUP_ROWS rows of an event, and the last to arrive sums the groups'
partials in order: no sum uses an atomic, and row e of a batched launch
has the bits of the B = 1 launch of event e, on every call.
"""
from __future__ import annotations

import ctypes
import operator

import torch

from repro_torch.kernels import _build

launches = 0

# csrc/lstsq_grad.cu's kGroupRows (rows a cluster, which fixes the order of
# the sum across groups) and kCluster (CTAs a cluster): the scratch holds a
# (B, G, d) partial, G = ceil(n / GROUP_ROWS), and the counters one int a
# (event, CTA rank).
GROUP_ROWS = 16
CLUSTER = 8
# The largest d the kernel takes (csrc: 8 float4 groups a thread x 8 CTAs x
# 256 threads).
MAX_D = 65536

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int] \
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# Per device: int32 arrival counters, zero between launches (each launch
# puts its counters back to 0), grown when a launch needs more.
_counters: dict[torch.device, torch.Tensor] = {}


def lstsq_grad(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
               n_t: int | None = None) -> torch.Tensor:
    """(d,) float32 gradient for contiguous float32 CUDA x (n, d), w (d,),
    y (n,); `n_t` (a host int, default n) counts the valid rows, and the
    padded rows past it are never read.  The batched kernel at B = 1."""
    name = "lstsq_grad"
    _build.require_dtype(name, torch.float32, x=x, w=w, y=y)
    n, d = _build.lstsq_shapes(name, x, w, y)
    n_t = n if n_t is None else int(n_t)
    if not 0 <= n_t <= n:
        raise ValueError(f"{name}: n_t must lie in [0, {n}], got {n_t}")
    _check_d(name, d)
    dev = _build.require_cuda(name, x=x, w=w, y=y)
    return _launch(dev, x, y, None, 0, None, n_t, w, 1, 1, n, d)[0]


def lstsq_grad_task(xs: torch.Tensor, ys: torch.Tensor, t: int,
                    w: torch.Tensor,
                    row_counts: torch.Tensor | None = None) -> torch.Tensor:
    """(d,) float32 gradient of task t (a host id; one outside [0, T)
    picks its task by `ref.task_index`) at w (d,), on the problem's
    buffers xs (T, n, d) and ys (T, n); `row_counts` (T,) int32 on the
    card, read there (None: every row is valid).  The batched kernel at
    B = 1."""
    name = "lstsq_grad_task"
    num_t, n, d = _check_buffers(name, xs, ys, row_counts)
    _build.require_dtype(name, torch.float32, w=w)
    if w.shape != (d,):
        raise ValueError(f"{name}: w must be ({d},), got {tuple(w.shape)}")
    try:
        t = operator.index(t)
    except TypeError:
        raise ValueError(f"{name}: t must be a host integer, got "
                         f"{type(t).__name__}") from None
    if not -2**31 <= t < 2**31:
        raise ValueError(f"{name}: t = {t} is not an int32")
    _check_d(name, d)
    dev = _require(name, xs, ys, row_counts, w=w)
    return _launch(dev, xs, ys, None, t, row_counts, n, w, 1, num_t, n, d)[0]


def lstsq_grad_batch(xs: torch.Tensor, ys: torch.Tensor, tasks: torch.Tensor,
                     w_rows: torch.Tensor,
                     row_counts: torch.Tensor | None = None) -> torch.Tensor:
    """(B, d) float32 full gradients of B events in one launch.

    xs (T, n, d) and ys (T, n) float32 are the problem's buffers, read in
    place; tasks (B,) int32 the events' task ids (one outside [0, T) picks
    its task by `ref.task_index`, the reference's dynamic index); w_rows
    (B, d) float32 the points; row_counts (T,) int32 or None.  All
    contiguous on one CUDA device.  Shapes, dtypes and sizes are checked
    before the device, so nothing is built for a call that cannot launch.
    """
    name = "lstsq_grad_batch"
    num_t, n, d = _check_buffers(name, xs, ys, row_counts)
    _build.require_dtype(name, torch.float32, w_rows=w_rows)
    _build.require_dtype(name, torch.int32, tasks=tasks)
    if tasks.dim() != 1:
        raise ValueError(f"{name}: tasks must be (B,), got "
                         f"{tuple(tasks.shape)}")
    b = tasks.shape[0]
    if w_rows.shape != (b, d):
        raise ValueError(f"{name}: w_rows must be ({b}, {d}), got "
                         f"{tuple(w_rows.shape)}")
    if b < 1:
        raise ValueError(f"{name}: the batch must hold an event, got B = 0")
    _check_d(name, d)
    dev = _require(name, xs, ys, row_counts, tasks=tasks, w_rows=w_rows)
    return _launch(dev, xs, ys, tasks, 0, row_counts, n, w_rows, b, num_t, n,
                   d)


def _check_buffers(name: str, xs, ys, row_counts) -> tuple[int, int, int]:
    _build.require_dtype(name, torch.float32, xs=xs, ys=ys)
    if row_counts is not None:
        _build.require_dtype(name, torch.int32, row_counts=row_counts)
    if xs.dim() != 3:
        raise ValueError(f"{name}: xs must be (T, n, d), got "
                         f"{tuple(xs.shape)}")
    num_t, n, d = xs.shape
    if ys.shape != (num_t, n) or (row_counts is not None
                                  and row_counts.shape != (num_t,)):
        raise ValueError(f"{name}: ys must be ({num_t}, {n}) and row_counts "
                         f"({num_t},); got {tuple(ys.shape)}, "
                         f"{None if row_counts is None else tuple(row_counts.shape)}")
    if num_t < 1:
        raise ValueError(f"{name}: xs holds no task")
    return num_t, n, d


def _check_d(name: str, d: int) -> None:
    if d > MAX_D:
        raise ValueError(f"{name}: d must be <= {MAX_D}, got {d}")


def _require(name: str, xs, ys, row_counts, **more) -> torch.device:
    extra = {} if row_counts is None else dict(row_counts=row_counts)
    return _build.require_cuda(name, xs=xs, ys=ys, **extra, **more)


def _launch(dev: torch.device, xs, ys, tasks, task: int, row_counts,
            n_t: int, w, b: int, num_t: int, n: int,
            d: int) -> torch.Tensor:
    global launches
    groups = max(-(-n // GROUP_ROWS), 1)
    g = torch.empty((b, d), dtype=torch.float32, device=dev)
    partial = torch.empty((b, groups, d), dtype=torch.float32, device=dev)
    counters = _counters.get(dev)
    if counters is None or counters.numel() < b * CLUSTER:
        counters = torch.zeros((max(b, 128) * CLUSTER,), dtype=torch.int32,
                               device=dev)
        _counters[dev] = counters
    fn = _build.function("lstsq_grad_launch", _ARGTYPES)
    err = fn(xs.data_ptr(), ys.data_ptr(),
             None if tasks is None else tasks.data_ptr(), task,
             None if row_counts is None else row_counts.data_ptr(), n_t,
             w.data_ptr(), g.data_ptr(), partial.data_ptr(),
             counters.data_ptr(), num_t, n, d, b, _build.stream(dev))
    _build.check(err, "lstsq_grad")
    launches += 1
    return g
