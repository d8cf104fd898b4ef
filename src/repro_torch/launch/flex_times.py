"""flex_attention's time at every flash shape of chip_smoke.py's phase 12,
beside the kernels' in the same run.

    PYTHONPATH=src python3 src/repro_torch/launch/flex_times.py [--seed N]

Run from the root of the repo, on the card.  The smoke compiles
flex_attention (the flash kernels' library yardstick, under torch.compile)
only at the served global prefill and the training shapes, to keep within
its time limit; this script runs the smoke's own phase-12 timing functions
with no shape left out (`FLEX_RECORDED` emptied): each route at its served
calls (`flash_times`, on phase 3's served inputs at `--seed`), the hybrid,
audio and MoE archs' forward shapes (`flash_hybrid_times`) and the
backward's training shapes (`flash_bwd_shape_times`), every kernel timed
beside flex_attention.  It prints the smoke's phase-12 lines and one JSON
line, `flex_times`.  It imports chip_smoke.py (torch and the port only).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]


def load_smoke():
    """chip_smoke.py from the root of the repo, as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flex_times needs a CUDA card")
    from repro_torch.kernels import _build
    smoke = load_smoke()
    smoke.FLEX_RECORDED = frozenset()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    print(smoke.card_line(), flush=True)
    _build.build(verbose=False)
    _build.load()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    served = smoke.check_flash_kernel(dev, gen)["flash_attention"]["served"]
    out = {"card": smoke.card_line(),
           "routes": smoke.flash_times(served, dev),
           "forward_shapes": smoke.flash_hybrid_times(dev),
           "backward_shapes": smoke.flash_bwd_shape_times(dev, {})}
    print(json.dumps({"flex_times": out}), flush=True)


if __name__ == "__main__":
    main()
