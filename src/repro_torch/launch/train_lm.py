"""End to end: train a ~100M-parameter LM with the AMTL multi-task
head (the port's twin of `examples/train_lm.py`).

    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \
        --steps 20 --small                                  # quick, CPU
    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 200  # card

Uses the example's granite-family configs (`--small`: granite-20m, 4
layers x d 256, vocab 8192; by default granite-100m, 12 layers x d 768,
vocab 16384; float32 both), the full train step (`launch.steps`: AdamW,
remat, and the paper's AMTL head update with nuclear-norm coupling in
every step), the synthetic LM stream placed one ahead by
`data.ShardedBatcher`, and a checkpoint of the params at the end
(`repro_torch.checkpoint`, the reference's npz record).  Prints the
example's loss lines (loss, lm, probe, Vnorm) and the head's six largest
singular values.  Runs on the card unless --device cpu is given; without
a card it raises.  `main` returns the logged rows, the singular values,
the parameter count and the record's path.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch

from repro_torch.checkpoint import save
from repro_torch.configs import get_config
from repro_torch.core.mtl_head import head_weights
from repro_torch.data import ShardedBatcher, synthetic_lm_batches
from repro_torch.launch.steps import (default_optimizer, init_train_state,
                                      make_train_step)

BATCH, SEQ, DATA_SEED = 8, 256, 1


def build_config(small: bool):
    base = get_config("granite-8b")
    if small:
        return dataclasses.replace(
            base, name="granite-20m", num_layers=4, d_model=256,
            num_heads=4, num_kv_heads=2, head_dim=64, d_ff=1024,
            vocab_size=8192, num_periods=4, dtype="float32")
    # ~100M: 12 x (d=768, ff=3072), vocab 16384
    return dataclasses.replace(
        base, name="granite-100m", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=3072,
        vocab_size=16384, num_periods=12, dtype="float32")


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    args = ap.parse_args(argv)

    cfg = build_config(args.small)
    opt = default_optimizer(cfg, lr=3e-4, total_steps=args.steps)
    state = init_train_state(cfg, opt, seed=0, device=args.device)
    dev = state.params.device
    n_params = state.params.num_params()
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{cfg.num_layers}L x d{cfg.d_model}, vocab {cfg.vocab_size}")

    step_fn = make_train_step(cfg, opt, remat=True)
    data = ShardedBatcher(synthetic_lm_batches(
        cfg.vocab_size, args.seq, args.batch, cfg.mtl.num_tasks,
        seed=DATA_SEED),
        device=dev)

    log = []
    t0 = time.time()
    for i, batch in zip(range(args.steps), data):
        state, m = step_fn(state, batch)
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            row = {"step": i, "loss": float(m["loss"]),
                   "lm": float(m["lm_loss"]),
                   "probe": float(m["probe_loss"]),
                   "Vnorm": float(m["mtl_v_norm"]),
                   "seconds": time.time() - t0}
            log.append(row)
            print(f"step {i:4d}  loss {row['loss']:7.4f}  "
                  f"lm {row['lm']:7.4f}  "
                  f"probe {row['probe']:8.5f}  "
                  f"Vnorm {row['Vnorm']:7.4f}  "
                  f"({row['seconds']:5.1f}s)")
    path = save(args.ckpt, int(state.step), state.params.tree())
    w = head_weights(state.mtl, cfg.mtl)
    s = torch.linalg.svdvals(w.float()).cpu()
    sv = [float(x) for x in s[:6]]
    print(f"checkpoint saved to {args.ckpt}; MTL head singular values "
          f"(nuclear coupling): {[round(x, 4) for x in sv]}")
    return dict(log=log, singular_values=sv, n_params=n_params,
                ckpt=path, step=int(state.step))


if __name__ == "__main__":
    main()
