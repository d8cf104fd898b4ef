"""The task mesh of the sharded AMTL engine, and a launcher of n-rank worlds
(port of `repro/launch/mesh.py :: make_task_mesh`).

The reference's mesh is a 1-D "tasks" axis over the devices of one
process.  The port's is one process a rank on `torch.distributed`:

    mesh = make_task_mesh()          # every rank of the initialised world,
                                     # or the 1-rank mesh without one
    engine = make_engine(problem, cfg, mesh=mesh)

`run_world(fn, n, *args)` starts such a world: n processes
(`torch.multiprocessing`, spawned), each joining the group through a
`file://` rendezvous in a fresh temporary directory (no TCP port, so
concurrent worlds cannot collide), each running `fn(*args)` and sending
its result back as numpy.  The backend follows the layout and is chosen
explicitly (`backend_for`): NCCL when every rank has a card of its own,
gloo when the ranks share one card or run on the CPU.  A failed init
raises; nothing falls back.  A rank that raises, or a world that does not
finish within `timeout`, raises in the parent with the rank's traceback,
and every rank is stopped; a collective that waits longer than
`collective_timeout` raises in its rank.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


class TaskMesh(NamedTuple):
    """A rank's view of the 1-D "tasks" mesh."""
    group: Any                 # the process group; None at one rank
    rank: int                  # this process's rank in the mesh
    size: int                  # ranks in the mesh (n_shards)
    device: torch.device       # the rank's device
    backend: str | None        # "gloo", "nccl"; None at one rank

    def n_local(self, num_tasks: int) -> int:
        """Task columns a rank owns: T / size (T must divide)."""
        if num_tasks % self.size != 0:
            raise ValueError(
                f"num_tasks ({num_tasks}) must be divisible by the 'tasks' "
                f"mesh axis size ({self.size})")
        return num_tasks // self.size


def make_task_mesh(num_shards: int | None = None,
                   device: torch.device | str | None = None) -> TaskMesh:
    """The 1-D "tasks" mesh of `num_shards` ranks (default: every rank).

    Without an initialised `torch.distributed` world there is one rank, as
    the reference's default mesh on a CPU is its one device.  In a world
    of W ranks a mesh is either every rank (the world's group) or one rank
    (each process a mesh of its own, no group).  `device` is the rank's
    device: CUDA unless the caller passes "cpu" (the current card of the
    process, which `run_world` sets).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if num_shards is None else num_shards
    if not 1 <= n <= world:
        raise ValueError(f"num_shards must be in [1, {world}] (ranks of the "
                         f"torch.distributed world), got {num_shards}")
    dev = resolve_device(device)
    if n == 1:
        return TaskMesh(None, 0, 1, dev, None)
    if n != world:
        raise ValueError(f"a mesh of {n} of the world's {world} ranks: the "
                         "mesh is every rank of the world or one")
    backend = dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL world runs on CUDA devices, not {dev}")
    return TaskMesh(dist.group.WORLD, dist.get_rank(), n, dev, backend)


def backend_for(n: int, device: str) -> tuple[str, list[str]]:
    """(backend, each rank's device) of an n-rank world on `device` ("cpu"
    or "cuda"): NCCL with card r for rank r when there are n cards or
    more, gloo with every rank on card 0 when there are fewer (the ranks
    share it; NCCL refuses two ranks on one card), gloo on the CPU."""
    if device == "cpu":
        return "gloo", ["cpu"] * n
    if device != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA world was asked for but CUDA is not "
                           "available")
    if torch.cuda.device_count() >= n:
        return "nccl", [f"cuda:{r}" for r in range(n)]
    return "gloo", ["cuda:0"] * n


def _host(x):
    """A result with every tensor turned into numpy (nested containers
    kept)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _rank_main(rank: int, n: int, init_file: str, backend: str,
               device: str, collective_timeout: float, fn: Callable,
               args: tuple, results) -> None:
    """A rank's process: join the group, run fn(*args), report (a CPU
    rank on one thread, so that worlds beside each other do not
    oversubscribe the cores)."""
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=n,
            rank=rank,
            timeout=datetime.timedelta(seconds=collective_timeout))
        try:
            out = _host(fn(*args))
        finally:
            if device != "cpu":
                torch.cuda.synchronize()
        results.put((rank, True, out))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_world(fn: Callable, n: int, *args, device: str = "cuda",
              timeout: float = 600.0, collective_timeout: float = 120.0,
              workdir: str | None = None,
              verbose: bool = True) -> list:
    """Run `fn(*args)` in each rank of an n-rank world; the ranks' results
    (tensors as numpy), in rank order.

    `fn` must be picklable (a module-level function of the port).  On
    "cuda" the kernel library is built here, once, before the ranks
    start.  The rendezvous file lives in a fresh directory under `workdir` (the
    system's temporary directory by default), removed at the end.
    """
    backend, devices = backend_for(n, device)
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    if verbose:
        print(f"world: {n} ranks, backend {backend}, devices {devices}",
              flush=True)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    if workdir is not None:
        os.makedirs(workdir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_", dir=workdir)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, n, os.path.join(tmp, "rendezvous"), backend, devices[r],
        collective_timeout, fn, args, results)) for r in range(n)]
    out: dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"the {n}-rank world did not finish within {timeout} s "
                    f"(ranks {sorted(set(range(n)) - set(out))} pending)")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a rank may have reported just before it exited
                    try:
                        rank, ok, val = results.get(timeout=1.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=30.0)
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n)]
