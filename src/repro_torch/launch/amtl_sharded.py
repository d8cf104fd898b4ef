"""Per-rank sessions of the sharded AMTL engine, for `launch.mesh.run_world`.

    from repro_torch.launch import amtl_sharded, mesh
    out = mesh.run_world(amtl_sharded.session, 2, spec, device="cuda")

`session(spec)` runs in every rank of the world.  It builds the problems
in the rank (from a seed, or from host arrays in the spec), keeps each
engine's block of its problem on the rank's device, runs the listed
engine sessions
in turn and returns, for each, the reference's global view of the final
state (`interop.state_to_numpy` over the mesh), the wall seconds of the
run, the collectives' calls, seconds and bytes, the kernels' launch
counts and, where asked, the device busy share of the run from
torch.profiler.  Every rank returns the same global state.

The spec (a dict of plain values; arrays as numpy):

  device        "cpu" or "cuda"
  problems      {name: problem}, each {"xs", "ys", "row_counts", "loss",
                "reg", "lam"} host arrays, or {"seed", "d", "t", "n",
                "lam", "tau"} for `make_problem`, or {"store_seed", "d",
                "t", "lo", "hi", "lam"} for `make_store`'s ragged TaskStore
  runs          a list of sessions, each {"problem": name, "cfg":
                AMTLConfig fields, "key": uint32[2], "events": N,
                "offsets": (T,) or None, "v0": (d, T), None (zeros) or the
                name of a seeded problem whose v0 it takes, "warmup": steps
                run and dropped first, "save": (dir, events) to checkpoint
                at, "restore": (dir, step) to resume from, "profile": bool,
                "solve": epochs of T events}

Imports torch, numpy and the port only.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core import AMTLConfig, MTLProblem, make_engine
from repro_torch.core.amtl import amtl_solve
from repro_torch.data import TaskStore
from repro_torch.distributed.sharding import (barrier, collective_stats,
                                              reset_collective_stats)
from repro_torch.interop import state_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_task_mesh


def make_problem(seed: int, dev, d: int, t: int, n: int, lam: float,
                 tau: int):
    """Seeded lstsq/nuclear problem on `dev`: Y = X W* + noise with a
    rank-4 W*; returns (problem, v0, delay offsets in [0, tau]).  The
    draws come from a torch.Generator on `dev`, so every process that
    calls it on the same card gets the same bits."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn(t, n, d, generator=gen, device=dev) / d ** 0.5
    w_star = (torch.randn(d, 4, generator=gen, device=dev)
              @ torch.randn(4, t, generator=gen, device=dev))
    ys = (torch.bmm(xs, w_star.T.unsqueeze(2)).squeeze(2)
          + 0.01 * torch.randn(t, n, generator=gen, device=dev))
    v0 = 0.01 * torch.randn(d, t, generator=gen, device=dev)
    offs = torch.randint(0, tau + 1, (t,), generator=gen, device=dev)
    return (MTLProblem(xs, ys, "lstsq", "nuclear", lam), v0,
            offs.to(torch.float32).cpu().numpy())


def make_store(seed: int, t: int, d: int, lo: int, hi: int, lam: float,
               tasks: range | None = None):
    """Ragged lstsq/nuclear cohorts of rng.integers(lo, hi) rows drawn
    from `seed`, rows N(0, 1/d), labels x w*_t + noise with a rank-4 W*,
    padded by a TaskStore.  Returns the store and a maker of further
    labelled rows of task t.  With `tasks` (a range) the store holds those
    tasks alone, padded to the whole store's capacity: every task's rows
    are drawn, in turn, and the others' dropped."""
    rng = np.random.default_rng(seed + 2)
    sizes = rng.integers(lo, hi, size=t)
    w_star = (rng.standard_normal((d, 4), dtype=np.float32)
              @ rng.standard_normal((4, t), dtype=np.float32))

    def rows(task: int, k: int):
        x = rng.standard_normal((k, d), dtype=np.float32) / np.float32(d ** 0.5)
        y = x @ w_star[:, task] + np.float32(0.01) * rng.standard_normal(
            k, dtype=np.float32)
        return x, y

    if tasks is None:
        xs, ys = zip(*(rows(i, int(n)) for i, n in enumerate(sizes)))
        return TaskStore.from_ragged(xs, ys, "lstsq", "nuclear", lam), rows
    cap = int(sizes.max())
    xs = np.zeros((len(tasks), cap, d), np.float32)
    ys = np.zeros((len(tasks), cap), np.float32)
    for i, n in enumerate(sizes):
        x, y = rows(i, int(n))
        if i in tasks:
            xs[i - tasks.start, :n], ys[i - tasks.start, :n] = x, y
    return TaskStore(xs, ys, sizes[tasks.start:tasks.stop], "lstsq",
                     "nuclear", lam), rows


def _problem(p: dict, dev):
    """(global problem, its own v0 or None), on the host: a seeded problem
    is drawn on `dev` and moved to the host, so the device keeps only the
    blocks the engines cut from it."""
    if "seed" in p:
        problem, v0, _ = make_problem(p["seed"], dev, p["d"], p["t"],
                                      p["n"], p["lam"], p["tau"])
        return problem._replace(xs=problem.xs.cpu(),
                                ys=problem.ys.cpu()), v0.cpu()
    if "store_seed" in p:
        store, _ = make_store(p["store_seed"], p["t"], p["d"], p["lo"],
                              p["hi"], p["lam"])
        return store.problem("cpu"), None
    counts = p.get("row_counts")
    return MTLProblem(
        torch.as_tensor(np.asarray(p["xs"], np.float32)),
        torch.as_tensor(np.asarray(p["ys"], np.float32)), p["loss"],
        p["reg"], float(p["lam"]),
        None if counts is None else torch.as_tensor(
            np.asarray(counts, np.int32))), None


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _busy(engine, state, offs, events: int, dev) -> dict:
    """Device busy seconds of one run from torch.profiler's CUDA activity
    (kernels and copies), and its device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run(state, offs, events)
        _sync(dev)
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return {"busy_s": sum(e.self_device_time_total for e in device) * 1e-6,
            "ops": sum(e.count for e in device)}


def _one_run(problems: dict, run: dict, mesh, dev) -> dict:
    cfg = AMTLConfig(**run["cfg"])
    problem, _ = problems[run["problem"]]
    v0 = run.get("v0")
    if isinstance(v0, str):
        v0 = problems[v0][1]
    elif v0 is None:
        v0 = np.zeros((problem.dim, problem.num_tasks), np.float32)
    key = np.asarray(run["key"], np.uint32)
    offs = run.get("offsets")
    if "solve" in run:
        res = amtl_solve(problem, cfg, v0, key, run["solve"],
                         delay_offsets=offs, mesh=mesh)
        return {"v": res.v, "w": res.w, "objectives": res.objectives,
                "residuals": res.residuals}
    engine = make_engine(problem, cfg, mesh=mesh)
    state = engine.init(v0, key)
    if run.get("warmup"):
        engine.run(state, offs, run["warmup"] * engine.events_per_step)
    if "restore" in run:
        ckpt_dir, step = run["restore"]
        state = checkpoint.restore(ckpt_dir, step, like=state, mesh=mesh,
                                   cfg=cfg)
    stops = [run["save"][1]] if "save" in run else []
    stops = [int(state.event), *stops, run["events"]]
    chunks = [b - a for a, b in zip(stops, stops[1:])]
    _sync(dev)
    barrier(mesh)
    ops.reset_launch_counts()
    reset_collective_stats()
    seconds = 0.0
    for i, n in enumerate(chunks):
        t0 = time.perf_counter()
        state = engine.run(state, offs, n)
        _sync(dev)
        seconds += time.perf_counter() - t0
        if i == 0 and "save" in run:
            checkpoint.save(run["save"][0], int(state.event), state,
                            mesh=mesh, cfg=cfg)
    launches = ops.launch_counts()
    coll = collective_stats()
    out = {"leaves": state_to_numpy(state, mesh=mesh, cfg=cfg),
           "seconds": seconds, "events": sum(chunks),
           "collectives": coll, "launches": launches}
    if run.get("profile"):
        # every rank runs the events again (the collectives need them
        # all); rank 0 under the profiler
        if mesh.rank == 0:
            out["busy"] = _busy(engine, engine.init(v0, key), offs,
                                run["events"], dev)
        else:
            engine.run(engine.init(v0, key), offs, run["events"])
            _sync(dev)
    return out


def session(spec: dict) -> list[dict]:
    """Run the spec's sessions in this rank (see the module doc)."""
    dev = torch.device(spec["device"]) if spec["device"] == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    mesh = make_task_mesh(device=dev)
    problems = {}
    results = []
    for run in spec["runs"]:
        for name in (run["problem"], run.get("v0")):
            if isinstance(name, str) and name not in problems:
                problems[name] = _problem(spec["problems"][name], dev)
        results.append(_one_run(problems, run, mesh, dev))
        _sync(dev)
    return results
