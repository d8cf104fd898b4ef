"""Serve a small model with batched requests: prefill + decode loop (the
port's twin of `examples/serve_batched.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve_batched --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_batched    # the card

Prefills a batch of 4 prompts of 24 tokens through a reduced gemma2-2b
(sliding-window + global attention, ring caches; float32) and greedily
decodes 16 tokens a request, at a cache of 40 slots, as the example does:
the prefill and the decode loop each timed in a window closed by a
synchronize, and the example's lines printed.  The weights come from the
port's init seeded by --seed, the prompts from numpy seeded by --seed + 1.
Like the example's code, it checks nothing as it goes: that each decode
step's logits equal a full forward of the prompt and the tokens so far is
tests/test_torch_lm_examples.py's check.  `main` returns the model, the
prompts, the tokens, the logits of the prefill and of each decode step and
the two windows' seconds.  Runs on the card unless --device cpu is given;
without a card it raises.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import make_prompts, sync
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import init_params

BATCH, PROMPT_LEN, GEN = 4, 24, 16


def main(argv: Optional[list[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("gemma2-2b").reduced()
    model = init_params(cfg, seed=args.seed, device=dev)
    b, prompt_len, gen = BATCH, PROMPT_LEN, GEN
    s_max = prompt_len + gen
    prompts = torch.as_tensor(make_prompts(cfg, b, prompt_len,
                                           args.seed + 1), device=dev)
    prefill = make_prefill_step(cfg, s_max=s_max)
    decode = make_decode_step(cfg)

    sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(model, prompts)
    sync(dev)
    prefill_s = time.perf_counter() - t0
    print(f"prefill: batch={b} len={prompt_len} in {prefill_s:.2f}s")

    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out_tokens, step_logits = [tok], [logits]
    sync(dev)
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(model, cache, tok, prompt_len + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out_tokens.append(tok)
        step_logits.append(logits)
    sync(dev)
    decode_s = time.perf_counter() - t0
    gen_toks = torch.cat(out_tokens, dim=1).cpu()
    print(f"decoded {gen} tokens x {b} requests in {decode_s:.2f}s "
          f"({b * gen / decode_s:.1f} tok/s on {dev})")
    for i in range(b):
        print(f"  req{i}: {gen_toks[i].tolist()}")
    return dict(model=model, prompts=prompts, tokens=gen_toks,
                logits=step_logits, prefill_s=prefill_s, decode_s=decode_s)


if __name__ == "__main__":
    main()
