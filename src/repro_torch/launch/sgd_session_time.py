"""Events/s of the AMTL sessions on the card, for comparing two trees.

    PYTHONPATH=src python3 src/repro_torch/launch/sgd_session_time.py

On the card, at full width, from --seed: the uniform batch cell of
`chip_smoke.py` (lstsq, nuclear, d 8192, T 128, n 256, tau 8, eta 0.05,
event_batch 32, prox_every 32, prox_rank 16); its uniform delta cell (the
same problem, full gradients, prox_every 8, one event a call),
--delta-events long; the dense l21 session (the same problem with the
l2,1 prox, the dense ring, an exact prox each event), DENSE_EVENTS
(256) long, as `chip_smoke.py`'s dense l21 session; the ragged SGD
batch session (the batch engine, minibatch 32, dynamic step) on 128
cohorts of 80..399 rows drawn from --seed and
published by a TaskStore (the widths and sizes of `chip_smoke.py`'s
ragged cohorts, not its data, and without its mid-run row append); and
the ragged SGD delta session on the same cohorts (prox_every 8),
--delta-events long; the logistic SGD delta session (the same cohorts
with labels sign(y), the logistic loss, minibatch 32, prox_every 8),
LOGISTIC_EVENTS (256) long.  Each runs its events after a warm-up of two steps
or two prox refreshes, timed on the host's clock up to a device
synchronize; then the same events again split into the host plan
(`plan_events`) and the device work (`apply_plan`); then one more
`apply_plan` under torch.profiler, whose device busy time (the sum of its
kernel and copy times) is read against that same run's wall time (the
profiler's own host cost included), and whose kernels and copies are
counted an event.  Last, FISTA (`fista_solve`, FISTA_ITERS (10)
iterations from zero on the uniform problem with the l2,1 prox, eta
0.05): seconds an iteration on the host's clock up to a synchronize after
a warm-up run, and one more run under torch.profiler for its busy time
and its kernels and copies an iteration.  Prints one JSON line: per
session the events/s, the plan and apply seconds, the profiled run's
seconds, busy share, device operations an event and its TOP (6) kernels
and copies by device seconds, and the kernel launches of the timed run;
FISTA's seconds, busy seconds, device
operations and launches an iteration; with the card's name and power
limit and the package it ran.

It reads only the engine session and solver API, the TaskStore and the
launch counts, so it runs against any tree of the port: put that tree's `src`
first on PYTHONPATH to compare two trees in one call (parent, change,
change, parent).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

D, T, N_ROWS, TAU = 8192, 128, 256, 8
ETA, LAM, RANK, BATCH = 0.05, 0.1, 16, 32
COHORT_LO, COHORT_HI, SGD_BATCH = 80, 400, 32
DENSE_EVENTS = 256
LOGISTIC_EVENTS = 256
FISTA_ITERS = 10
TOP = 6


def uniform_problem(seed: int, dev):
    """chip_smoke.py's batch cell: Y = X W* + noise with a rank-4 W*."""
    from repro_torch.core import MTLProblem
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn(T, N_ROWS, D, generator=gen, device=dev) / D ** 0.5
    w_star = (torch.randn(D, 4, generator=gen, device=dev)
              @ torch.randn(4, T, generator=gen, device=dev))
    ys = (torch.bmm(xs, w_star.T.unsqueeze(2)).squeeze(2)
          + 0.01 * torch.randn(T, N_ROWS, generator=gen, device=dev))
    v0 = 0.01 * torch.randn(D, T, generator=gen, device=dev)
    offs = torch.randint(0, TAU + 1, (T,), generator=gen, device=dev)
    return (MTLProblem(xs, ys, "lstsq", "nuclear", LAM), v0,
            offs.to(torch.float32).cpu().numpy())


def ragged_problem(seed: int, dev):
    """128 cohorts of 80..399 rows of a rank-4 lstsq problem drawn from
    `seed`, published by a TaskStore."""
    from repro_torch.data import TaskStore
    rng = np.random.default_rng(seed + 2)
    sizes = rng.integers(COHORT_LO, COHORT_HI, size=T)
    w_star = (rng.standard_normal((D, 4), dtype=np.float32)
              @ rng.standard_normal((4, T), dtype=np.float32))
    xs, ys = [], []
    for t, n in enumerate(sizes):
        x = rng.standard_normal((int(n), D), dtype=np.float32) \
            / np.float32(D ** 0.5)
        xs.append(x)
        ys.append(x @ w_star[:, t] + np.float32(0.01) * rng.standard_normal(
            int(n), dtype=np.float32))
    return TaskStore.from_ragged(xs, ys, "lstsq", "nuclear",
                                 LAM).problem(dev)


def sync(dev) -> None:
    torch.cuda.synchronize(dev)


def profiled(fn) -> tuple[float, float, int, list]:
    """(wall seconds, device busy seconds, device kernels and copies, the
    TOP kernels and copies with the most device seconds) of fn() under
    torch.profiler, up to a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    top = sorted(([e.key[:60], e.self_device_time_total * 1e-6, e.count]
                  for e in device), key=lambda r: -r[1])[:TOP]
    return (wall, sum(e.self_device_time_total for e in device) * 1e-6,
            sum(e.count for e in device), top)


def session(problem, cfg, v0, key, offs, events: int, dev) -> dict:
    from repro_torch.core import amtl, make_engine
    from repro_torch.kernels import ops
    engine = make_engine(problem, cfg, device=dev)
    state0 = engine.init(v0, key)
    engine.run(state0, offs,                                   # warm up
               2 * max(engine.events_per_step, cfg.prox_every))
    sync(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    engine.iterate(engine.run(state0, offs, events))
    sync(dev)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    t0 = time.perf_counter()
    plan = amtl.plan_events(problem, cfg, state0, offs, events)
    host = time.perf_counter() - t0
    t0 = time.perf_counter()
    amtl.apply_plan(problem, cfg, state0, plan)
    sync(dev)
    apply_s = time.perf_counter() - t0
    profiled_s, busy, n_ops, top = profiled(
        lambda: amtl.apply_plan(problem, cfg, state0, plan))
    return {"events_per_s": events / wall, "wall_s": wall, "plan_s": host,
            "apply_s": apply_s, "profiled_apply_s": profiled_s,
            "busy_s": busy, "busy_share": busy / profiled_s,
            "device_ops_per_event": n_ops / events, "launches": counts,
            "top": top}


def fista(problem, dev) -> dict:
    """FISTA_ITERS iterations of `fista_solve` from zero."""
    from repro_torch.core import fista_solve
    from repro_torch.kernels import ops
    w0 = torch.zeros((D, T), dtype=torch.float32, device=dev)
    run = lambda: fista_solve(problem, w0, ETA, FISTA_ITERS, device=dev)
    run()                                                      # warm up
    sync(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run()
    sync(dev)
    wall = time.perf_counter() - t0
    counts = {k: v / FISTA_ITERS for k, v in ops.launch_counts().items()
              if v}
    profiled_s, busy, n_ops, top = profiled(run)
    return {"s_per_iteration": wall / FISTA_ITERS, "wall_s": wall,
            "profiled_s": profiled_s, "busy_s": busy,
            "busy_share": busy / profiled_s,
            "device_ops_per_iteration": n_ops / FISTA_ITERS,
            "launches_per_iteration": counts, "top": top}


def main(argv: list[str] | None = None) -> dict:
    import repro_torch
    from repro_torch.core import AMTLConfig, prng
    from repro_torch.core.operators import amtl_max_step
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--events", type=int, default=4096)
    ap.add_argument("--delta-events", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sgd_session_time: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = AMTLConfig(eta=ETA, eta_k=amtl_max_step(TAU, T, 0.9), tau=TAU,
                     prox_rank=RANK, engine="batch", event_batch=BATCH,
                     prox_every=BATCH)
    key = prng.key_from_seed(args.seed)
    problem, v0, offs = uniform_problem(args.seed, dev)
    out = {"uniform batch": session(problem, cfg, v0, key, offs,
                                    args.events, dev)}
    delta = cfg._replace(engine="delta", event_batch=1, prox_every=8)
    out["uniform delta"] = session(problem, delta, v0, key, offs,
                                   args.delta_events, dev)
    out["dense l21"] = session(
        problem._replace(reg_name="l21"),
        delta._replace(engine="dense", prox_every=1, prox_rank=None), v0,
        key, offs, DENSE_EVENTS, dev)
    out["FISTA"] = fista(problem._replace(reg_name="l21"), dev)
    del problem
    ragged = ragged_problem(args.seed, dev)
    sgd = cfg._replace(batch_size=SGD_BATCH, dynamic_step=True)
    out["ragged SGD batch"] = session(ragged, sgd, v0, key, offs,
                                      args.events, dev)
    sgd_delta = sgd._replace(engine="delta", event_batch=1, prox_every=8)
    out["ragged SGD delta"] = session(ragged, sgd_delta, v0, key, offs,
                                      args.delta_events, dev)
    logistic = ragged._replace(ys=torch.where(ragged.ys > 0, 1.0, -1.0),
                               loss_name="logistic")
    out["logistic SGD delta"] = session(logistic, sgd_delta, v0, key, offs,
                                        LOGISTIC_EVENTS, dev)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out["package"] = repro_torch.__file__
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
