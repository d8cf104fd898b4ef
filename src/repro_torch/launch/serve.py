"""Serving driver: batched prefill + greedy decode loop on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --reduced --device cpu                       # plain versions, CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --batch 2 --prompt-len 5000 --gen 32         # full width, the card

Port of `repro/launch/serve.py` on one device (sharded serving waits for
ROADMAP.md Queue 1 item 11(i)).  Prompts come from numpy seeded by --seed, the
weights from the port's init with a torch.Generator seeded by --seed on the
device.  On the card every attention call of prefill and decode runs the
flash-attention CUDA kernels, and every WKV recurrence of rwkv6-3b one of
the rwkv6_scan kernels: the chunked tensor-core route in a bf16 prefill,
the recurrent one in decode (its O(1) state ignores the prompt and
generation lengths).  Without --device cpu and without a CUDA device it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import SERVED, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import LM, init_params


def serve_config(arch: str, reduced: bool = False) -> ArchConfig:
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, name=cfg.name + "-reduced")
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode loop")
    return cfg


def make_prompts(cfg: ArchConfig, batch: int, prompt_len: int,
                 seed: int) -> np.ndarray:
    """(batch, prompt_len) int64 token ids from numpy seeded by `seed`."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, prompt_len),
                        dtype=np.int64)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: LM, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> dict:
    """Prefill the prompts (B, P) and decode `gen` tokens, greedily unless
    `temperature` > 0 (then sampled with `generator`).  Returns the tokens
    (B, gen) and the host seconds of prefill and of the gen - 1 decode
    steps, each ended by a device synchronize."""
    cfg = model.cfg
    dev = model.device
    b, p = prompts.shape
    prefill_fn = make_prefill_step(cfg, s_max=p + gen)
    decode_fn = make_decode_step(cfg)

    def sample(lg: torch.Tensor) -> torch.Tensor:
        if temperature <= 0:
            return torch.argmax(lg[:, -1], dim=-1)
        probs = torch.softmax(lg[:, -1] / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(model, prompts)
    tok = sample(logits)[:, None]
    sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode_fn(model, cache, tok, p + i)
        tok = sample(logits)[:, None]
        out.append(tok)
    sync(dev)
    decode_s = time.perf_counter() - t0
    return dict(tokens=torch.cat(out, dim=1), prefill_s=prefill_s,
                decode_s=decode_s)


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=SERVED, required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = serve_config(args.arch, args.reduced)
    dev = resolve_device(args.device)
    model = init_params(cfg, seed=args.seed, device=dev)
    print(f"{cfg.name}: {model.num_params() / 1e6:.1f}M params, "
          f"batch={args.batch}, prompt={args.prompt_len}, gen={args.gen}, "
          f"device={dev}")
    prompts = torch.as_tensor(make_prompts(cfg, args.batch, args.prompt_len,
                                           args.seed), device=dev)
    generator = torch.Generator(device=dev).manual_seed(args.seed + 3)
    r = generate(model, prompts, args.gen, args.temperature, generator)
    print(f"prefill: {r['prefill_s']:.2f}s "
          f"({args.batch * args.prompt_len} tokens)")
    print(f"decoded {args.gen} x {args.batch} tokens in {r['decode_s']:.2f}s "
          f"({args.batch * args.gen / max(r['decode_s'], 1e-9):.1f} tok/s)")
    toks = r["tokens"].cpu()
    for i in range(min(args.batch, 4)):
        print(f"  req{i}: {toks[i].tolist()}")
    return r


if __name__ == "__main__":
    main()
