"""The task axis of the sharded AMTL engine and its collectives (port of
the AMTL part of `repro/distributed/sharding.py`).

The reference partitions the T task columns over a 1-D "tasks" mesh axis
inside one process (`shard_map`).  The port runs one process a rank on
`torch.distributed` (`launch.mesh.TaskMesh`), so a placement is not a
PartitionSpec but a statement of which leaves a rank holds whole, which
it holds a block of, and how the global view is put together from the
ranks' pieces.  `task_shard_specs` names the leaves of each placement
class; `prox_cache_spec` places the prox cache.  The mesh has the one
axis `TASK_AXIS`.

The collectives the engine needs, each on the mesh's group:

  gather_columns   (rows, n_local) blocks -> (rows, n_local * size), the
                   blocks in rank order, their bytes unchanged (the
                   replicated prox's stale iterate, the distributed prox's
                   (p, n_local) core blocks, `iterate`)
  gather_shards    (k, ...) leaves -> (k * size, ...) in rank order (the
                   per-rank undo rings, for a checkpoint)
  sum_partials     the elementwise sum over ranks (the distributed prox's
                   (d, p) partial sketches)
  broadcast        rank 0's tensor on every rank (the lockstep server's
                   folded rows, `serve.lockstep`)
  barrier

At one rank each is the identity: no process group, no copy.  The
tensors stay on the rank's device: gloo takes CUDA tensors in all_gather
and all_reduce (it copies them through host memory itself; checked on an
H100 with PyTorch 2.11), NCCL takes them on the card.
`collective_stats` counts each call, its host seconds (until the call
returns), the bytes of its result and the threads that issued them.
"""
from __future__ import annotations

import threading
import time
from typing import Any

import torch
import torch.distributed as dist

TASK_AXIS = "tasks"

_STATS: dict[str, Any] = {"calls": 0, "seconds": 0.0, "bytes": 0,
                          "threads": set()}


def task_shard_specs() -> dict[str, tuple[str, ...]]:
    """The leaves of each placement class of the task-sharded engine; the
    engine's conversions between a rank's view and the global view
    (`core.amtl.shard_problem`, `gather_state`, `local_state`,
    `init_sharded_state`) read this table.

      per_task   — leading-dim-T problem leaves: a rank holds the rows of
                   its tasks [rank * n_local, (rank + 1) * n_local)
      columns    — (d, T) iterates: a rank holds its (d, n_local) columns
      per_shard  — a rank's own (1, ...) slice of an (n_shards, ...) leaf:
                   its private undo ring
      replicated — every rank holds the same value: the serial PRNG chain
                   state, the global-id task ring, and the delay history

    The history is per_task in the reference (each shard records the
    delays of its own tasks); the port keeps it on the host, where every
    rank replays the whole chain and records every event, so it is
    replicated, and its global view is the reference's.  The
    rank-distributed prox adds no class: its (d, p) sum and its gathered
    (p, T) core are replicated, its reconstruction `columns`.  The prox
    cache's class depends on the config (`prox_cache_spec`).
    """
    return {
        "per_task": ("xs", "ys", "row_counts"),
        "columns": ("v",),
        "per_shard": ("delta_ring",),
        "replicated": ("task_ring", "ptr", "event", "history", "key"),
    }


def prox_cache_spec(prox_mode: str, carried: bool) -> str:
    """The placement class of the sharded engine's prox cache.

    The replicated prox gives every rank the whole (d, T) result, so its
    cache is replicated.  The rank-distributed prox reconstructs only the
    rank's own columns, so a carried cache (prox_every > event_batch) is
    `columns`, like the iterate.  The (0, 0) stub of the aligned cadence
    stays replicated in either mode.
    """
    if prox_mode == "distributed" and carried:
        return "columns"
    return "replicated"


def collective_stats() -> dict[str, Any]:
    """Calls, seconds, result bytes and issuing threads (their
    `threading.get_ident()`) of the collectives since the last
    `reset_collective_stats` (in this process)."""
    return dict(_STATS, threads=set(_STATS["threads"]))


def reset_collective_stats() -> None:
    _STATS.update(calls=0, seconds=0.0, bytes=0, threads=set())


def _record(t0: float, out: torch.Tensor | None) -> torch.Tensor | None:
    _STATS["calls"] += 1
    _STATS["seconds"] += time.perf_counter() - t0
    if out is not None:
        _STATS["bytes"] += out.numel() * out.element_size()
    _STATS["threads"].add(threading.get_ident())
    return out


def _gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return _record(t0, torch.cat(parts, dim=dim))


def gather_columns(x: torch.Tensor, mesh) -> torch.Tensor:
    """(rows, n_local) blocks of every rank -> (rows, n_local * size), the
    blocks in rank order with their exact bits.  The identity at one
    rank."""
    if mesh is None or mesh.size == 1:
        return x
    return _gather(x, mesh, 1)


def gather_shards(x: torch.Tensor, mesh) -> torch.Tensor:
    """(k, ...) leaves of every rank -> (k * size, ...) in rank order.  The
    identity at one rank."""
    if mesh is None or mesh.size == 1:
        return x
    return _gather(x, mesh, 0)


def sum_partials(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise sum of x over the ranks, the same bits on every
    rank.  The identity at one rank."""
    if mesh is None or mesh.size == 1:
        return x
    t0 = time.perf_counter()
    out = x.clone()
    dist.all_reduce(out, group=mesh.group)
    return _record(t0, out)


def broadcast(x: torch.Tensor, mesh) -> torch.Tensor:
    """Rank 0's x on every rank (x is overwritten on the others; its
    shape and dtype must agree).  The identity at one rank."""
    if mesh is None or mesh.size == 1:
        return x
    t0 = time.perf_counter()
    dist.broadcast(x, src=0, group=mesh.group)
    return _record(t0, x)


def barrier(mesh) -> None:
    """Wait for every rank of the mesh (nothing at one rank)."""
    if mesh is None or mesh.size == 1:
        return
    t0 = time.perf_counter()
    dist.barrier(group=mesh.group)
    _record(t0, None)
