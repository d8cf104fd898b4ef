"""Host time of gemma2-2b's greedy decode step and of its attention calls.

    PYTHONPATH=src python3 src/repro_torch/launch/host_time.py

On the card, gemma2-2b at its published width (random weights from
--seed) prefills B x P tokens, then each of --reps decode steps is timed
twice on the host's clock: until the step's Python returns with every
launch queued (its host time), and until a device synchronize after it
(its wall time).  The step queues ~5 ms of device work, far less than its
host time, so the host never waits on the device inside a step.  Then one
attention call (`ops.mha`) at each decode cache of the step (the local
layers' 4096-slot ring and the global layers' cache) is issued 200 times
back to back, and its host time a call taken the same way.

It reads only `ops.mha` and the serve driver, so it runs against any tree
of the port that serves gemma2-2b: put that tree's `src` first on
PYTHONPATH to compare two trees in one call.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch


def step_times(model, prompts: torch.Tensor, reps: int) -> dict:
    """Median host and wall ms of `reps` greedy decode steps after a
    prefill of `prompts` (B, P)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    cfg, dev = model.cfg, model.device
    b, p = prompts.shape
    prefill_fn = make_prefill_step(cfg, s_max=p + reps + 1)
    decode_fn = make_decode_step(cfg)
    logits, cache = prefill_fn(model, prompts)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    host, wall = [], []
    for i in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = decode_fn(model, cache, tok, p + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        t1 = time.perf_counter()
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return dict(step_host_ms=statistics.median(host),
                step_wall_ms=statistics.median(wall))


def mha_host_us(dev, b: int, skv: int, kv_len: int, calls: int = 200,
                seed: int = 0) -> float:
    """Host us a call of `ops.mha` at gemma2-2b's decode shape (bf16, Sq 1,
    H 8, Hkv 4, hd 256, softcap 50) on a cache of `skv` slots."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, 1, 8, 256, generator=g, device=dev).bfloat16()
    k = torch.randn(b, skv, 4, 256, generator=g, device=dev).bfloat16()
    v = torch.randn(b, skv, 4, 256, generator=g, device=dev).bfloat16()

    def call():
        return ops.mha(q, k, v, causal=False, softcap=50.0,
                       kv_valid_len=kv_len, kv_chunk=4096)
    for _ in range(3):
        call()
    times = []
    for _ in range(5):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize(dev)
    return statistics.median(times)


def measure(model, prompts: torch.Tensor, reps: int) -> dict:
    dev = model.device
    b, p = prompts.shape
    out = step_times(model, prompts, reps)
    out["mha_ring_host_us"] = mha_host_us(dev, b, 4096, 4096)
    out["mha_global_host_us"] = mha_host_us(dev, b, p + reps + 1, p + 1)
    return out


def main(argv: list[str] | None = None) -> dict:
    import repro_torch
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=5000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_time: needs a CUDA card")
    dev = torch.device("cuda")
    cfg = serve.serve_config("gemma2-2b")
    model = init_params(cfg, seed=args.seed, device=dev)
    prompts = torch.as_tensor(serve.make_prompts(
        cfg, args.batch, args.prompt_len, args.seed), device=dev)
    serve.generate(model, prompts[:, :128], 2)        # build and warm up
    out = measure(model, prompts, args.reps)
    out["package"] = repro_torch.__file__
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
