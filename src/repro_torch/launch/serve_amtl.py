"""Learning-while-serving: an AMTL session behind a prediction API (the
port's twin of `examples/serve_amtl.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve_amtl --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_amtl       # the card

Streams request batches through an `AMTLServer` in four parts:

  1. serve and checkpoint: every batch is scored off the committed
     serving snapshot, feedback is coalesced into engine chunks under
     per-task QoS caps, and the session checkpoints on a rotating
     `keep_last` window;
  2. crash and `resume`: the server is dropped and resumed from its
     newest rotated checkpoint, and every later prediction is bitwise an
     uninterrupted server's;
  3. the threaded learner with an SLO: the server restarts with a 250 ms
     predict SLO, predictions flow from the main thread while the
     learner thread absorbs feedback, and after the drain the state is
     bitwise ONE plain `engine.run` over every event;
  4. chaos under a scripted `FaultPlan`: NaN feedback rejected at
     admission, a learner crash healed by the supervisor, a poisoned
     iterate quarantined, and a crash between the store and engine
     checkpoint writes bridged by `resume`, with the served snapshot
     finite throughout.

Runs on the card unless --device cpu is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import AMTLConfig, make_engine, prng
from repro_torch.data import make_mtl_problem
from repro_torch.device import resolve_device
from repro_torch.serve import (AMTLServer, FaultPlan, InjectedFault,
                               ServeConfig)

BATCHES = 12
REQUESTS = 16          # prediction rows per request batch
FEEDBACK = 5           # feedback items per request batch


def _traffic(problem, seed: int):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, problem.num_tasks, size=(BATCHES, REQUESTS))
    x = rng.standard_normal((BATCHES, REQUESTS, problem.dim)) \
        .astype(np.float32)
    fb = rng.integers(0, problem.num_tasks, size=(BATCHES, FEEDBACK))
    return t, x, fb


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    problem = make_mtl_problem(num_tasks=6, samples=40, dim=32, rank=2,
                               lam=0.1, seed=args.seed, device=dev)
    cfg = AMTLConfig(eta=1.0 / problem.lipschitz(), eta_k=0.9, tau=4,
                     engine="delta", prox_every=4, prox_rank=4)
    w0 = np.zeros((problem.dim, problem.num_tasks), np.float32)
    key = prng.key_from_seed(args.seed)
    t, x, fb = _traffic(problem, args.seed)
    print(f"[boot ] device {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))

    with tempfile.TemporaryDirectory() as ckpt_dir:
        serve_cfg = ServeConfig(chunk_events=16, task_chunk_quota=4,
                                max_pending_per_task=16,
                                ckpt_dir=ckpt_dir, checkpoint_every=10,
                                keep_last=3, max_batch=REQUESTS)
        # the reference server runs uninterrupted; the "production" one
        # crashes mid-stream and resumes from its rotated checkpoints
        ref = AMTLServer(problem, cfg, w0, key,
                         serve_cfg._replace(ckpt_dir=None,
                                            checkpoint_every=None),
                         device=dev)
        server = AMTLServer(problem, cfg, w0, key, serve_cfg, device=dev)

        for i in range(BATCHES // 2):
            preds, receipt, ran = server.serve(t[i], x[i], fb[i])
            ref.serve(t[i], x[i], fb[i])
            print(f"[serve] batch {i}: {preds.shape[0]} preds, "
                  f"{receipt.accepted} feedback accepted, "
                  f"{ran} events learned")
        # pending feedback is the one thing a crash loses, so the demo
        # crashes with an empty queue to keep the replay bitwise
        while server.pending_feedback:
            server.step()
            ref.step()
        server.checkpoint()
        records = sorted(f for f in os.listdir(ckpt_dir)
                         if f.endswith(".npz"))
        print(f"[ckpt ] rotated window (keep_last=3): {records}")
        assert len(records) <= 3

        # -- crash + restart: resume from the newest rotated record ----
        del server
        server = AMTLServer.resume(problem, cfg, w0, key, serve_cfg,
                                   device=dev)
        print(f"[boot ] resumed at event {server.event_count}")
        for i in range(BATCHES // 2, BATCHES):
            preds, _, _ = server.serve(t[i], x[i], fb[i])
            ref_preds, _, _ = ref.serve(t[i], x[i], fb[i])
            assert torch.equal(preds, ref_preds), \
                "restart must be bitwise invisible to predictions"
        print(f"[serve] batches {BATCHES // 2}..{BATCHES - 1}: resumed "
              "predictions bitwise == uninterrupted server")
        assert server.stats()["events"] == ref.stats()["events"]

        # -- threaded serving with an SLO: the learner owns the loop ----
        server.checkpoint()
        server = AMTLServer.resume(problem, cfg, w0, key,
                                   serve_cfg._replace(slo_ms=250.0,
                                                      slo_window=4),
                                   device=dev)
        start_event = server.event_count
        chunks_before = len(server.chunk_log)
        learner = server.start_learner()
        for i in range(BATCHES):
            server.predict(t[i], x[i])
            server.submit_feedback(fb[i])
        server.stop_learner(drain=True)   # finish every runnable chunk
        new_chunks = server.chunk_log[chunks_before:]
        slo = server.stats()["slo"]
        print(f"[thread] learner absorbed {learner.events} events in "
              f"{learner.chunks} chunks while the main thread served; "
              f"SLO {slo['slo_ms']} ms: {slo['violations']} of "
              f"{slo['samples']} predicts over it, level {slo['level']}")
        assert server.event_count == start_event + sum(new_chunks)
        eng = make_engine(problem, cfg, dev)
        state = eng.run(eng.init(w0, key), None, server.event_count)
        assert torch.equal(server.iterate(), eng.iterate(state)), \
            "threaded serving must replay the chunk log bitwise"

    _chaos_part(problem, cfg, w0, key, t, x, dev)
    print("OK: learning-while-serving with QoS, rotating checkpoints, a "
          "restart-transparent resume, a concurrent learner thread, and "
          "scripted-fault recovery (restart, quarantine, torn checkpoint).")


def _chaos_part(problem, cfg, w0, key, t, x, dev) -> None:
    """All four injected fault types against one supervised session."""
    rng = np.random.default_rng(1)

    def rows(k, seed):
        r = np.random.default_rng(seed)
        return (r.integers(0, problem.num_tasks, size=k),
                (r.standard_normal((k, problem.dim))
                 / np.sqrt(problem.dim)).astype(np.float32),
                r.standard_normal(k).astype(np.float32))

    with tempfile.TemporaryDirectory() as ckpt_dir:
        plan = FaultPlan(nan_feedback=[(0, 2)],      # labeled call 0, row 2
                         crash_on_chunks={1},        # learner dies, heals
                         poison_iterate_on_chunks={3},   # quarantined
                         fail_checkpoint_calls={1})  # store/engine split
        serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=ckpt_dir,
                                restart_limit=2, restart_backoff_s=0.01)
        server = AMTLServer(problem, cfg, w0, key, serve_cfg, device=dev,
                            fault_plan=plan)
        receipt = server.submit_feedback(*rows(4, 0))
        print(f"[chaos] NaN feedback: {receipt.accepted} accepted, "
              f"{receipt.rejected} rejected (reason={receipt.reason})")
        assert receipt.reason == "nonfinite"

        server.start_learner()
        for i in range(10):
            server.predict(t[i % len(t)], x[i % len(x)])
            server.submit_feedback(rng.integers(0, problem.num_tasks,
                                                size=4))
        deadline = time.perf_counter() + 60.0
        while time.perf_counter() < deadline:
            health = server.stats()["health"]
            if (health["learner_restarts"] >= 1
                    and health["nonfinite_chunks"] >= 1):
                break
            time.sleep(0.01)
        server.stop_learner(drain=True)
        health = server.stats()["health"]
        print(f"[chaos] crash healed: restarts={health['learner_restarts']}"
              f" recovery_ms={[round(ms, 1) for ms in health['recovery_ms']]}"
              f" | quarantined={health['quarantined_feedback']} events "
              f"across {health['nonfinite_chunks']} poisoned chunk(s)")
        assert health["learner_restarts"] == 1
        assert health["nonfinite_chunks"] == 1
        assert bool(torch.isfinite(server.iterate()).all()), \
            "the served snapshot must never go non-finite"

        server.checkpoint()                    # call 0: whole record pair
        server.submit_feedback(*rows(4, 2))
        server.step()
        try:
            server.checkpoint()                # call 1: torn mid-pair
            raise AssertionError("the scripted checkpoint crash did not fire")
        except InjectedFault:
            print("[chaos] checkpoint torn between store and engine "
                  "writes (scripted)")
        resumed = AMTLServer.resume(problem, cfg, w0, key, serve_cfg,
                                    device=dev)
        print(f"[chaos] resumed at event {resumed.event_count} from the "
              f"surviving record pair")
        assert 0 < resumed.event_count < server.event_count
        assert bool(torch.isfinite(resumed.iterate()).all())


if __name__ == "__main__":
    main()
