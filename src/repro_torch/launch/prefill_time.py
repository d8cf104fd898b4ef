"""Prefill time of a served arch on the card, for comparing two trees.

    PYTHONPATH=src python3 src/repro_torch/launch/prefill_time.py \
        --arch rwkv6-3b

On the card, the arch at its published width (random weights from
--seed) prefills B x P prompt tokens --reps times after a warm-up prefill
of the same shape; each prefill is timed on the host's clock up to a
device synchronize.  Prints one JSON line: the median and every time, the
prefill tokens/s of the median, the card's name and power limit, and the
package it ran.

It reads only the serve driver and the prefill step, so it runs against
any tree of the port: put that tree's `src` first on PYTHONPATH to compare
two trees in one call (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch


def main(argv: list[str] | None = None) -> dict:
    import repro_torch
    from repro_torch.configs import SERVED
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=SERVED, default="rwkv6-3b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=5000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prefill_time: needs a CUDA card")
    dev = torch.device("cuda")
    cfg = serve.serve_config(args.arch)
    model = init_params(cfg, seed=args.seed, device=dev)
    prompts = torch.as_tensor(serve.make_prompts(
        cfg, args.batch, args.prompt_len, args.seed), device=dev)
    prefill = make_prefill_step(cfg, s_max=args.prompt_len)
    prefill(model, prompts)                       # build and warm up
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        prefill(model, prompts)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"arch": args.arch, "batch": args.batch,
           "prompt_len": args.prompt_len, "prefill_s": med,
           "prefill_s_all": times,
           "prefill_tokens_per_s": args.batch * args.prompt_len / med,
           "card": card, "package": repro_torch.__file__}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
