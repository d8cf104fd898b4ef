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
its result back as numpy.  `World(n)` keeps its ranks up for several
calls (`world.run(fn, *args)`, each call on every rank, then
`world.close()`): the spawn, the imports, the card's context and the
group's rendezvous are paid once, and while the parent works on before
its first call.  The backend follows the layout and is chosen
explicitly (`backend_for`): NCCL when every rank has a card of its own,
gloo when the ranks share one card or run on the CPU.  A failed init
raises; nothing falls back.  A rank that raises, or a call that does not
finish within `timeout`, raises in the parent with the rank's traceback,
and every rank is stopped (the world is closed); a collective that waits
longer than `collective_timeout` raises in its rank.  A rank that dies
without a result (a signal, the host's OOM killer) is named with its
signal, and the other ranks' reports, each due within the collective
timeout, are awaited and joined to the error.
"""
from __future__ import annotations

import datetime
import gc
import os
import queue as queue_mod
import shutil
import signal
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
               device: str, collective_timeout: float, calls,
               results) -> None:
    """A rank's process: join the group, then run each (fn, args) that
    `calls` brings and report it, until None (a CPU rank on one thread,
    so that worlds beside each other do not oversubscribe the cores).  A
    failed call ends the rank: its world is closed by the parent."""
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(torch.device(device))
            torch.zeros(1, device=device)       # the card's context, now
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=n,
            rank=rank,
            timeout=datetime.timedelta(seconds=collective_timeout))
        while (call := calls.get()) is not None:
            fn, args = call
            try:
                out = _host(fn(*args))
            finally:
                if device != "cpu":
                    torch.cuda.synchronize()
            results.put((rank, True, out))
            del out
            gc.collect()
            if device != "cpu":
                torch.cuda.empty_cache()
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def exit_reason(code: int) -> str:
    """A dead process's exit code in words: the signal that killed it
    (a negative code), or the code."""
    if code is not None and code < 0:
        try:
            name = signal.Signals(-code).name
        except ValueError:
            name = f"signal {-code}"
        why = (" (the host's OOM killer is the usual cause)"
               if -code == signal.SIGKILL else "")
        return f"was killed by {name}{why}"
    return f"exited with code {code}"


def _world_error(procs, out: dict, results, n: int, reports: list,
                 wait_s: float) -> RuntimeError:
    """The error of a world with a failed or dead rank: every rank that
    died without a result, named with its signal, then every failure
    report, after waiting up to `wait_s` for the ranks still running to
    report or die (each raises within its collective timeout)."""
    reported = {r for r, _ in reports} | set(out)
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        running = [r for r in range(n) if r not in reported
                   and procs[r].exitcode is None]
        if not running:
            break
        try:
            rank, ok, val = results.get(timeout=0.5)
        except queue_mod.Empty:
            continue
        reported.add(rank)
        if not ok:
            reports.append((rank, val))
    try:                      # a report that raced its rank's exit
        while True:
            rank, ok, val = results.get_nowait()
            reported.add(rank)
            if not ok:
                reports.append((rank, val))
    except queue_mod.Empty:
        pass
    dead = [f"rank {r} {exit_reason(procs[r].exitcode)} without a result"
            for r in range(n)
            if r not in reported and procs[r].exitcode is not None]
    return RuntimeError("\n".join(
        dead + [f"rank {r} of {n} failed:\n{val}"
                for r, val in sorted(reports)]))


class World:
    """n ranks of one torch.distributed world, kept up across calls.

    `World(n, device)` spawns the ranks and returns at once; each joins
    the group (and, on "cuda", makes its card's context) while the parent
    goes on.  `run(fn, *args)` runs `fn(*args)` in every rank and returns
    the ranks' results (tensors as numpy), in rank order; `close()` stops
    the ranks (also as a context manager).  `fn` must be picklable (a
    module-level function of the port).  On "cuda" the kernel library is
    built here, once, before the ranks start.  The rendezvous file lives
    in a fresh directory under `workdir` (the system's temporary directory
    by default), removed at `close`.
    """

    def __init__(self, n: int, device: str = "cuda",
                 collective_timeout: float = 120.0,
                 workdir: str | None = None, verbose: bool = True):
        backend, devices = backend_for(n, device)
        if device == "cuda":
            from repro_torch.kernels import _build
            _build.build()
        if verbose:
            print(f"world: {n} ranks, backend {backend}, devices {devices}",
                  flush=True)
        self.n = n
        self.collective_timeout = collective_timeout
        ctx = torch.multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._calls = [ctx.Queue() for _ in range(n)]
        if workdir is not None:
            os.makedirs(workdir, exist_ok=True)
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_world_",
                                     dir=workdir)
        self._procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, n, os.path.join(self._tmp, "rendezvous"), backend,
            devices[r], collective_timeout, self._calls[r], self._results))
            for r in range(n)]
        self._open = True
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.close(kill=True)
            raise

    def run(self, fn: Callable, *args, timeout: float = 600.0) -> list:
        """`fn(*args)` in every rank; the ranks' results in rank order.
        A rank that fails or dies, or a call not done within `timeout`,
        closes the world and raises."""
        if not self._open:
            raise RuntimeError("the world is closed")
        n, procs, results = self.n, self._procs, self._results
        out: dict[int, Any] = {}
        try:
            for q in self._calls:
                q.put((fn, args))
            deadline = time.monotonic() + timeout
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"the {n}-rank world did not finish within "
                        f"{timeout} s (ranks "
                        f"{sorted(set(range(n)) - set(out))} pending)")
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
                            raise _world_error(
                                procs, out, results, n, [],
                                min(self.collective_timeout + 10.0,
                                    max(0.0, deadline - time.monotonic())))
                    else:
                        continue
                if not ok:
                    raise _world_error(procs, out, results, n, [(rank, val)],
                                       min(5.0, max(0.0, deadline -
                                                    time.monotonic())))
                out[rank] = val
        except BaseException:
            self.close(kill=True)
            raise
        return [out[r] for r in range(n)]

    def close(self, kill: bool = False) -> None:
        """Stop the ranks: each leaves the group and exits (within 30 s,
        else it is killed), or, with `kill`, is killed at once."""
        if not self._open:
            return
        self._open = False
        started = [p for p in self._procs if p.pid is not None]
        try:
            if not kill:
                for q, p in zip(self._calls, self._procs):
                    if p.pid is not None and p.is_alive():
                        q.put(None)
                for p in started:
                    p.join(timeout=30.0)
        finally:
            for p in started:
                if p.is_alive():
                    p.kill()
            for p in started:
                p.join(timeout=10.0)
            for q in self._calls:
                # a call a stopped rank never read is dropped, not waited on
                q.cancel_join_thread()
            for q in (self._results, *self._calls):
                q.close()
            shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, kind, *_) -> None:
        self.close(kill=kind is not None)


def run_world(fn: Callable, n: int, *args, device: str = "cuda",
              timeout: float = 600.0, collective_timeout: float = 120.0,
              workdir: str | None = None,
              verbose: bool = True) -> list:
    """Run `fn(*args)` in each rank of a fresh n-rank world; the ranks'
    results (tensors as numpy), in rank order (a `World` for one call)."""
    with World(n, device=device, collective_timeout=collective_timeout,
               workdir=workdir, verbose=verbose) as world:
        return world.run(fn, *args, timeout=timeout)
