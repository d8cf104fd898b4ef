"""Training driver (port of `repro/launch/train.py`) on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --reduced --device cpu --steps 50            # the CPU twin
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --steps 4 --batch 2 --seq 2048               # full width, the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --reduced --device cpu --steps 3 --seq 32 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \
        --reduced --device cpu --steps 3 --seq 32 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
        --reduced --device cpu --steps 3 --seq 40 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v3-671b --reduced --device cpu --steps 3 --seq 32 \
        --batch 2                                    # also dbrx-132b

Each step is `launch.steps.make_train_step`'s: the backbone's forward
and backward (on the card every attention call in the flash kernels, its
gradient in `flash_attention_bwd`; every WKV in the `rwkv6_scan` kernels,
its gradient in `rwkv6_bwd`; the Mamba-2 SSD, the routed MoE FFN and
the MTP loss in plain PyTorch under autograd), the smooth optimizer's
update (AdamW, or Adafactor for deepseek), and one AMTL round of the
multi-task head.  Every arch of `configs.SERVED` trains: gemma2-2b,
rwkv6-3b and hubert-xlarge (the audio encoder on frame features, its
loss over the masked frames) at full width
on one card; zamba2-7b (the mamba blocks and the weight-tied shared
attention with its LoRA) and llama-3.2-vision-11b (the gated
cross-attention over the vision embeddings that its batches carry) at
their published widths on one card only with fewer periods (at 13 and 8
periods their bf16 weights and gradients and AdamW's state, 16 bytes a
parameter, pass 80 GB; chip_smoke.py cuts the depth); granite-8b,
nemotron-4-15b and gemma3-12b reduced (at full width their AdamW state
alone, 12 bytes a parameter, passes one card's 80 GB: the sharded LM is
ROADMAP item 11(i)); dbrx-132b and deepseek-v3-671b (the routed MoE with
its aux loss, MLA, deepseek's MTP loss) reduced, and on one card only at
their published widths with the depth cut (chip_smoke.py phases 37-38:
dbrx on its first layer of 40, deepseek on its 3 dense MLA layers and
the MTP block, under Adafactor; one deepseek MoE layer's weights,
gradients and float32 master pass the card alone).
The batches are `synthetic_lm_batches`' stream (the reference's bytes
for the same seed), placed one ahead by `data.ShardedBatcher`.  It prints
the reference's log line; `main` returns the per-step numbers.

`--ckpt DIR` writes the params through `repro_torch.checkpoint` in the
reference's npz record every `--ckpt-every` steps and at the end, and
resumes the params and the step from the latest record, as the
reference's driver does.  The record holds float32 params (the reduced
configs); bfloat16 leaves have no numpy dtype to write and raise.  There
is no `--mesh`: the sharded LM waits for ROADMAP.md Queue 1 item 11(i).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import SERVED, get_config
from repro_torch.data import ShardedBatcher, synthetic_lm_batches
from repro_torch.launch.steps import (default_optimizer, init_train_state,
                                      make_train_step)
from repro_torch.optim.optimizers import tree_get, tree_items


def batches_for(cfg, seq: int, batch: int, seed: int = 1):
    """The reference's synthetic LM stream matching the arch's input
    modality: the vision embeddings of a vlm; for the audio family frame
    features, a mask of the frames to predict (30 %, from numpy seeded
    with seed + 1) and the targets taken mod the vocabulary."""
    base = synthetic_lm_batches(
        cfg.vocab_size, seq, batch, cfg.mtl.num_tasks, seed=seed,
        vision_seq=cfg.vision_seq if cfg.family == "vlm" else 0,
        d_model=cfg.d_model, audio_dim=cfg.feature_dim)
    if cfg.family != "audio":
        return base

    def with_mask():
        rng = np.random.default_rng(seed + 1)
        for b in base:
            b["mask"] = rng.random((batch, seq)) < 0.3
            b["targets"] = b["targets"] % cfg.vocab_size
            yield b
    return with_mask()


def train_config(arch: str, reduced: bool):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, name=cfg.name + "-reduced")
    return cfg


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=SERVED, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized variant of the same family")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; the card "
                         "otherwise")
    args = ap.parse_args(argv)

    cfg = train_config(args.arch, args.reduced)
    opt = default_optimizer(cfg, lr=args.lr, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt, remat=not args.no_remat)
    state = init_train_state(cfg, opt, seed=args.seed, device=args.device)
    dev = state.params.device

    start = 0
    if args.ckpt and (last := latest_step(args.ckpt)) is not None:
        params = state.params.tree()
        back = restore(args.ckpt, last, params)
        with torch.no_grad():
            for path, leaf in tree_items(params):
                leaf.copy_(tree_get(back, path))
        state = state._replace(step=last)
        start = last
        print(f"resumed from {args.ckpt} step {last}")

    print(f"{cfg.name}: {state.params.num_params() / 1e6:.1f}M params on "
          f"{dev} (1 device)")
    data = ShardedBatcher(batches_for(cfg, args.seq, args.batch), device=dev)
    log = []
    t0 = time.time()
    for i, batch in zip(range(start, args.steps), data):
        state, m = step_fn(state, batch)
        row = {"step": i, "loss": float(m["loss"]),
               "lm_loss": float(m["lm_loss"]),
               "probe_loss": float(m["probe_loss"]),
               "mtl_active_frac": float(m["mtl_active_frac"]),
               "mtl_mean_staleness": float(m["mtl_mean_staleness"]),
               "mtl_v_norm": float(m["mtl_v_norm"]),
               "seconds": time.time() - t0}
        log.append(row)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {row['loss']:8.4f}  "
                  f"lm {row['lm_loss']:8.4f}  "
                  f"probe {row['probe_loss']:8.5f}  "
                  f"({row['seconds']:6.1f}s)", flush=True)
        if args.ckpt and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            save(args.ckpt, i + 1, state.params.tree())
    if args.ckpt:
        save(args.ckpt, args.steps, state.params.tree())
        print(f"final checkpoint: {args.ckpt}/step_{args.steps:08d}.npz")
    return log


if __name__ == "__main__":
    main()
