"""Where the full-gradient kernel spends its time, on the card.

    PYTHONPATH=src python3 src/repro_torch/launch/grad_kernel_phases.py

Builds variants of `csrc/lstsq_grad.cu`, each with `nvcc` into its own
library under `build/sgd_kernel_phases/`, and times them on the card at
the batch cell's widths (128 tasks of 256 rows, d 8192; CUDA events
behind a device sleep, median of 7 windows of 10 launches): at B 1 (one
task again, L2-warm; and the next of the 128 tasks each call, L2-cold)
and at a 32-event step (32 distinct tasks, 268 MB of X, cold by size):

- `grad_full`: the kernel as it is;
- `grad_no_tail`: each CTA leaves once its group's partial is written (no
  arrival, no sum across groups; the gradient is wrong, only the time is
  read);
- `grad_no_cluster_sum`: each CTA takes its own partial dot products for the
  whole (the cluster barrier and the distributed-shared-memory reads cut;
  wrong gradients);
- `grad_no_rows`: no group reads X (launch, task and count reads, arrival and
  the sum across groups of stale partials);
- `grad_empty`: `grad_no_rows` and `grad_no_tail` together, the launch of the 8-CTA
  clusters alone;
- `grad_spans`: %globaltimer at each block's start and end: the launch's span
  from the first block's start to the last block's end, and a block's
  median time.

Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import lstsq_grad as k_grad
from repro_torch.launch.sgd_kernel_phases import (SPAN_END, build, cut,
                                                  device_us, spanned, spans)

D, T, N, B = 8192, 128, 256, 32
ROWS = ("  const int rows = min(kGroupRows, n_t - row0);",
        "  const int rows = min(kGroupRows, n_t - row0) * 0 - 1;")
TAIL = ("  // The last of the event's G CTAs of this rank to arrive sums the "
        "slice:",
        "  if (rows > 0) cluster_wait();\n  return;\n"
        "  // The last of the event's G CTAs of this rank to arrive sums the "
        "slice:")
CLUSTER_SUM = (
    "      cluster.sync();\n      if (tid < cnt) {\n"
    "        float pv[kCluster];\n",
    "      __syncthreads();\n      if (tid < cnt) {\n"
    "        float pv[kCluster];\n")
REMOTE = ("pv[q] = *cluster.map_shared_rank(&part[buf][tid], q);",
          "pv[q] = part[buf][tid];")
START = "  cg::cluster_group cluster = cg::this_cluster();\n"
END = "\n}\n\ntemplate <int V>\nint launch_v"
EARLY = "    return;                         // reads its part[]\n"


def variants() -> dict[str, str]:
    src = (_build.CSRC / "lstsq_grad.cu").read_text()
    return {"grad_full": src,
            "grad_no_tail": cut(src, TAIL),
            "grad_no_cluster_sum": cut(src, CLUSTER_SUM, REMOTE),
            "grad_no_rows": cut(src, ROWS),
            "grad_empty": cut(src, ROWS, TAIL),
            # a CTA that is not the last to arrive leaves early: its end
            # time is taken there too
            "grad_spans": cut(spanned(src, START, END),
                              (EARLY, SPAN_END[1:] + EARLY))}


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("grad_kernel_phases: needs a CUDA card")
    libs = build(variants())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    xs = torch.randn(T, N, D, generator=gen, device=dev) / D ** 0.5
    ys = torch.randn(T, N, generator=gen, device=dev)
    w = torch.randn(B, D, generator=gen, device=dev)
    step = torch.randperm(T, generator=gen, device=dev)[:B].to(torch.int32)
    groups = -(-N // k_grad.GROUP_ROWS)
    partial = torch.empty((B, groups, D), device=dev)
    counters = torch.zeros((B * k_grad.CLUSTER,), dtype=torch.int32,
                           device=dev)
    g = torch.empty((B, D), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for name, lib in libs.items():
        fn = lib.lstsq_grad_launch
        fn.argtypes, fn.restype = k_grad._ARGTYPES, ctypes.c_int
        walk = itertools.cycle(range(T))

        def call(b, task=None, fn=fn, name=name):
            t = next(walk) if task is None else task
            _build.check(fn(xs.data_ptr(), ys.data_ptr(),
                            step.data_ptr() if b > 1 else None, t, None, N,
                            w.data_ptr(), g.data_ptr(), partial.data_ptr(),
                            counters.data_ptr(), T, N, D, b, stream), name)
        if name == "grad_spans":
            for b in (1, B):
                result[f"spans B {b}"] = spans(
                    lib, b * groups * k_grad.CLUSTER,
                    lambda b=b: call(b, task=3))
            continue
        result[name] = {"B 1 L2-warm": device_us(lambda: call(1, task=3)),
                        "B 1 L2-cold": device_us(lambda: call(1)),
                        f"B {B}": device_us(lambda: call(B))}
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print("grad_kernel_phases " + json.dumps(result, default=float),
          flush=True)
    return result


if __name__ == "__main__":
    main()
