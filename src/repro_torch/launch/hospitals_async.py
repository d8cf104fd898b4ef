"""The paper's motivating scenario: hospitals with private data, slow links
(the port's twin of `examples/hospitals_async.py`).

    PYTHONPATH=src python -m repro_torch.launch.hospitals_async --device cpu
    PYTHONPATH=src python -m repro_torch.launch.hospitals_async    # the card

12 'hospitals' (task nodes) each hold a private patient cohort of a
different size (drawn from seed 0); 3 sit behind slow links (SLOW).  Six
tasks are regression (length of stay), six classification (readmission).

  1. the float64 event-driven simulators: wall clock and objective of
     synchronous against asynchronous optimization, and the dynamic step;
  2. the batch engine on the ragged cohorts as an open-ended stream of
     64-event chunks (SGD-AMTL, prox every 4 batches, the slow hospitals
     at 5x the staleness), checkpointed mid-stream and restored, bitwise
     the uninterrupted session;
  3. learn-while-serve: an `AMTLServer` folds each accepted labelled row
     into its `TaskStore` at the next chunk boundary (the cohorts grow
     through a capacity doubling), against a label-free twin fed the same
     events, whose predictions the grown data moves.

Prints the example's lines and returns their numbers.  Runs on the card
unless --device cpu is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core import (NetworkModel, SimProblem, backward,
                              default_config, make_engine, prng,
                              simulate_amtl, simulate_smtl)
from repro_torch.data import stack_ragged
from repro_torch.device import resolve_device
from repro_torch.serve import AMTLServer, ServeConfig

SLOW = (2, 5, 8)                  # hospitals behind slow links


def make_hospitals(seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(80, 400, size=12)
    d = 32
    w_shared = rng.standard_normal(d)
    xs, ys, losses = [], [], []
    for i, n in enumerate(sizes):
        x = rng.standard_normal((n, d)) / np.sqrt(d)
        w_t = w_shared + 0.3 * rng.standard_normal(d)
        z = x @ w_t + 0.1 * rng.standard_normal(n)
        if i % 2 == 0:
            ys.append(z)                       # length-of-stay regression
            losses.append("lstsq")
        else:
            ys.append(np.where(z > 0, 1.0, -1.0))   # readmission classifier
            losses.append("logistic")
        xs.append(x)
    return SimProblem(xs, ys, losses, "nuclear", 0.1), sizes


def simulate(problem, sizes, out: dict) -> None:
    """Part 1: wall-clock study on the event-driven simulator."""
    compute = [n * 2e-4 for n in sizes]
    net = NetworkModel(delay_offset=2.0, delay_jitter=8.0,
                       compute_time=compute, prox_time=0.05)
    epochs = 15
    sync = simulate_smtl(problem, net, epochs, seed=0)
    async_ = simulate_amtl(problem, net, epochs, seed=0)
    dyn = simulate_amtl(problem, net, epochs, seed=0, dynamic_step=True)
    for name, r in (("smtl", sync), ("amtl", async_), ("amtl+dynstep", dyn)):
        out[f"sim_{name}"] = (r.total_time, r.objectives[-1])
        print(f"[{name:12s}] {r.total_time:8.1f} s   "
              f"objective {r.objectives[-1]:10.2f}")
    out["speedup"] = sync.total_time / async_.total_time
    print(f"asynchrony speedup at equal epochs: {out['speedup']:.2f}x "
          f"(paper Tables I/III direction)")
    assert async_.total_time < sync.total_time


def ragged_engine_problem(problem, dev):
    """The hospitals' cohorts, ragged, as one padded engine problem."""
    xs = [np.asarray(x, np.float32) for x in problem.xs]
    ys = [np.asarray(y, np.float32) for y in problem.ys]
    return stack_ragged(xs, ys, "lstsq", "nuclear", 0.1, device=dev)


def stream(problem, sizes, dev, out: dict) -> None:
    """Part 2: the batch engine as a long-lived checkpointed session."""
    ragged = ragged_engine_problem(problem, dev)
    counts = ragged.host_row_counts()
    assert counts.tolist() == [len(x) for x in problem.xs]
    print(f"[stream      ] ragged cohorts {counts.min()}..{counts.max()} "
          f"padded to cap {ragged.xs.shape[1]} "
          f"({counts.sum()} of {ragged.num_tasks * ragged.xs.shape[1]} "
          f"rows valid)")
    cfg = default_config(ragged, tau=8, engine="batch", event_batch=8,
                         prox_every=32, dynamic_step=True, batch_size=32)
    engine = make_engine(ragged, cfg, dev)
    # Slow hospitals read at ~5x the mean staleness of the fast ones.
    offsets = np.asarray([5.0 if i in SLOW else 1.0
                          for i in range(ragged.num_tasks)], np.float32)
    key = prng.key_from_seed(0)
    w0 = torch.zeros((ragged.dim, ragged.num_tasks), dtype=torch.float32,
                     device=dev)
    obj0 = float(ragged.objective(w0))

    # The stream: 30 chunks of 64 events arrive; the server dies after 15.
    chunk, n_chunks = 64, 30
    state = engine.init(w0, key)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for _ in range(n_chunks // 2):
            state = engine.run(state, offsets, chunk)
        checkpoint.save(ckpt_dir, int(state.event), state)
        out["stream_checkpoint"] = int(state.event)
        print(f"[stream      ] checkpoint at event {int(state.event)}")
        state = checkpoint.restore(ckpt_dir, checkpoint.latest_step(ckpt_dir),
                                   like=engine.init(w0, key))
        for _ in range(n_chunks - n_chunks // 2):
            state = engine.run(state, offsets, chunk)

    # Reference: the same session without the restart — must match bitwise.
    ref = engine.run(engine.init(w0, key), offsets, n_chunks * chunk)
    out["stream_bitwise"] = torch.equal(engine.iterate(state),
                                        engine.iterate(ref))
    assert out["stream_bitwise"]
    w = backward(ragged, engine.iterate(state), cfg.eta)
    obj = float(ragged.objective(w))
    out["stream_objective"] = (obj0, obj)
    print(f"[stream      ] {int(state.event)} events, objective "
          f"{obj0:.1f} -> {obj:.1f} (restart was bitwise-invisible)")
    assert obj < obj0


def feedback(problem, sizes, dev, out: dict) -> None:
    """Part 3: learn-while-serve with label-carrying feedback ingestion."""
    ragged = ragged_engine_problem(problem, dev)
    cfg = default_config(ragged, tau=8, engine="batch", event_batch=8,
                         prox_every=8)
    w0 = np.zeros((ragged.dim, ragged.num_tasks), np.float32)
    serve_cfg = ServeConfig(chunk_events=32)
    key = prng.key_from_seed(1)
    server = AMTLServer(ragged, cfg, w0, key, serve_cfg, device=dev)
    twin = AMTLServer(ragged, cfg, w0, key, serve_cfg, device=dev)

    rng = np.random.default_rng(42)
    n_queries = 8
    q_t = rng.integers(0, ragged.num_tasks, size=n_queries)
    q_x = (rng.standard_normal((n_queries, ragged.dim))
           / np.sqrt(ragged.dim)).astype(np.float32)

    cap0 = server.problem.xs.shape[1]
    busy = int(np.argmax(sizes))           # the busiest hospital admits most
    for _ in range(24):
        k = 32
        fb_t = np.full(k, busy, np.int64)
        fb_t[: k // 2] = rng.integers(0, ragged.num_tasks, size=k // 2)
        fb_x = (rng.standard_normal((k, ragged.dim))
                / np.sqrt(ragged.dim)).astype(np.float32)
        fb_y = fb_x @ rng.standard_normal(ragged.dim).astype(np.float32)
        # server ingests the labeled rows; the twin gets the same EVENTS
        # with no data — isolating what the grown cohorts contribute
        server.submit_feedback(fb_t, fb_x, fb_y)
        twin.submit_feedback(fb_t)
        server.step()
        twin.step()

    grown = server._store
    out["feedback"] = (grown.num_rows - int(np.sum(sizes)), int(sizes[busy]),
                       int(grown.row_counts[busy]), cap0, grown.capacity)
    print(f"[feedback    ] {out['feedback'][0]} new "
          f"patient rows ingested at chunk boundaries; busiest hospital "
          f"{sizes[busy]} -> {grown.row_counts[busy]} rows; buffer "
          f"capacity {cap0} -> {grown.capacity} (power-of-two doubling)")
    assert grown.capacity > cap0
    out["chunks_equal"] = server.chunk_log == twin.chunk_log
    assert out["chunks_equal"]

    p_grown = server.predict(q_t, q_x).cpu().numpy()
    p_twin = twin.predict(q_t, q_x).cpu().numpy()
    out["drift"] = float(np.max(np.abs(p_grown - p_twin)))
    print(f"[feedback    ] same events, +/- the ingested rows: predictions "
          f"moved by up to {out['drift']:.4f}")
    assert out["drift"] > 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    problem, sizes = make_hospitals()
    out = {"sizes": sizes.tolist()}
    print(f"hospitals: {len(sizes)} cohorts, sizes {sizes.tolist()}")
    simulate(problem, sizes, out)
    stream(problem, sizes, dev, out)
    feedback(problem, sizes, dev, out)
    print("OK: no hospital waits for the slowest link; raw data never "
          "leaves a node (only d-dim model vectors move); cohorts of any "
          "size join unpadded and keep growing mid-session; the server "
          "checkpoints and resumes mid-stream without perturbing the "
          "event sequence.")
    return out


if __name__ == "__main__":
    main()
