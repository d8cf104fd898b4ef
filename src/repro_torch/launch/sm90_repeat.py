"""Repeat the `sm90` flash forward at windowed shapes and count the launches
whose output is not bitwise the first launch's.

    PYTHONPATH=src python3 src/repro_torch/launch/sm90_repeat.py [--reps N]

On the card, for each shape (B, S, H, Hkv, hd, window, softcap; causal,
bf16, inputs drawn from a seeded generator) one launch is kept and --reps
more are compared with it.  The kernel has no atomics and a fixed order of
sums, so every count must be 0.  The shapes have a window, so that some of
a block's consumer warpgroups skip the first key tiles of the ring, with
three consumers a block (hd <= 128) and two (hd 256).

It reads only `flash_attention.flash_attention(..., route="sm90")`, so it
runs against any tree of the port whose `sm90` route takes these shapes:
put that tree's `src` first on PYTHONPATH to compare two trees in one
call.  Prints one line a shape and one JSON line.
"""
from __future__ import annotations

import argparse
import json

import torch

SHAPES = ((2, 1000, 32, 16, 112, 256, 50.0),
          (2, 1000, 32, 16, 128, 256, 50.0),
          (2, 2000, 8, 4, 256, 300, 50.0),
          (2, 1000, 16, 16, 80, 200, None))


def differing_launches(shape: tuple, reps: int, gen: torch.Generator,
                       dev: torch.device) -> int:
    """Launches of `reps` whose output differs from the first's."""
    from repro_torch.kernels import flash_attention as k_flash
    b, s, h, hkv, hd, window, cap = shape
    q = torch.randn(b, s, h, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, s, hkv, hd, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(causal=True, window=window, softcap=cap, q_offset=0,
              kv_len=None)
    first = k_flash.flash_attention(q, k, v, route="sm90", **kw)
    return sum(not torch.equal(
        k_flash.flash_attention(q, k, v, route="sm90", **kw), first)
        for _ in range(reps))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sm90_repeat needs a CUDA card")
    from repro_torch.kernels import _build
    _build.build(verbose=False)
    _build.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out = []
    for shape in SHAPES:
        bad = differing_launches(shape, args.reps, gen, dev)
        b, s, h, hkv, hd, window, cap = shape
        print(f"B {b} S {s} H {h} Hkv {hkv} hd {hd} window {window} softcap "
              f"{cap}: {bad} of {args.reps} launches differ from the first",
              flush=True)
        out.append(dict(shape=list(shape), reps=args.reps, differing=bad))
    print(json.dumps({"sm90_repeat": out}), flush=True)


if __name__ == "__main__":
    main()
