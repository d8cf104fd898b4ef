"""Quickstart: solve a low-rank multi-task regression with AMTL (the port's
twin of `examples/quickstart.py`).

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.launch.quickstart       # the card

Builds the paper's synthetic shared-subspace problem (8 tasks, 100
samples, dim 40, rank 3), solves it three ways (centralized FISTA,
synchronous SMTL, asynchronous AMTL) and shows they reach the same
optimum, then streams the same AMTL session in chunks through the session
API with a checkpoint and a restore at half-time, which reproduces the
one-shot solve bitwise.  Prints the example's lines and returns their
numbers.  Runs on the card unless --device cpu is given; without a card
it raises.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch import checkpoint
from repro_torch.core import (AMTLConfig, amtl_solve, make_engine, prng,
                              reference_optimum, smtl_solve)
from repro_torch.data import make_mtl_problem
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    problem = make_mtl_problem(num_tasks=8, samples=100, dim=40, rank=3,
                               lam=0.1, seed=0, device=dev)
    eta = 1.0 / problem.lipschitz()
    d, t = problem.dim, problem.num_tasks
    w0 = torch.zeros((d, t), dtype=torch.float32, device=dev)
    out = {}

    w_star, obj_star = reference_optimum(problem, num_iters=1000, device=dev)
    out["fista"] = float(obj_star)
    print(f"[fista]  optimum objective      : {out['fista']:.5f}")

    sync = smtl_solve(problem, w0, eta, 300, device=dev)
    out["smtl"] = float(sync.objectives[-1])
    print(f"[smtl ]  objective after 300 it : {out['smtl']:.5f}")

    cfg = AMTLConfig(eta=eta, eta_k=0.9, tau=4)
    key = prng.key_from_seed(0)
    res = amtl_solve(problem, cfg, w0, key, num_epochs=300, device=dev)
    out["amtl"] = float(res.objectives[-1])
    out["residual"] = float(res.residuals[-1])
    print(f"[amtl ]  objective after 300 ep : {out['amtl']:.5f}"
          f"   (fixed-point residual {out['residual']:.2e})")

    # -- the session API: same engine, streamed ------------------------
    # 300 epochs == 300*T events; stream them in chunks of 25 epochs,
    # checkpoint at half-time, restore, and finish the stream.
    engine = make_engine(problem, cfg, dev)
    total, chunk = 300 * t, 25 * t
    state = engine.init(w0, key)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        while int(state.event) < total // 2:
            state = engine.run(state, None, chunk)
        checkpoint.save(ckpt_dir, int(state.event), state)
        out["checkpoint_event"] = int(state.event)
        print(f"[sess ]  checkpointed at event  : {out['checkpoint_event']}")
        # simulated restart: rebuild from the serialized state alone
        step = checkpoint.latest_step(ckpt_dir)
        state = checkpoint.restore(ckpt_dir, step,
                                   like=engine.init(w0, key))
        while int(state.event) < total:
            state = engine.run(state, None, chunk)
    out["resume_bitwise"] = torch.equal(engine.iterate(state), res.v)
    assert out["resume_bitwise"], \
        "resumed session must replay the one-shot solve bitwise"
    out["resumed_event"] = int(state.event)
    print(f"[sess ]  resumed to event       : {out['resumed_event']}"
          "   (bitwise == one-shot amtl_solve)")

    out["gap"] = abs(out["amtl"] - out["fista"])
    print(f"[amtl ]  gap to global optimum  : {out['gap']:.2e}")
    out["rank"] = int(torch.sum(torch.linalg.svdvals(res.w) > 1e-3))
    print(f"[amtl ]  learned rank (true 3)  : {out['rank']}")
    assert out["gap"] < 1e-2, "AMTL failed to reach the optimum"
    print("OK: asynchronous updates reach the same optimum as FISTA/SMTL, "
          "and the session survives a checkpoint/restart.")
    return out


if __name__ == "__main__":
    main()
