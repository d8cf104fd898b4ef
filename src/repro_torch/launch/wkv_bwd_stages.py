"""Where a block of the chunked WKV backward spends its time, stage by stage.

    PYTHONPATH=src python3 src/repro_torch/launch/wkv_bwd_stages.py

Builds a copy of `csrc/rwkv6_bwd_chunked.cu` with `nvcc` under
`build/wkv_bwd_stages/` in which thread 0 of every block of
`rwkv6_bwd_chunk_kernel` writes `clock64()` after each of the block's
barriers (and `%globaltimer` at its start and end) into a device array.
It runs the route once at the rwkv6-3b training shape (B 2, L 2048, H 40,
D 64, bf16, w at the model's init), checks that the copy gives the
library's bits, and prints one JSON line:

- `stage_cycles`: the mean cycles over the blocks between successive
  barriers: `load` (the chunk's rows, S and G staged), `E`, `G chain`,
  then for each sub-chunk `A` (decays, dA, scores within blocks,
  rowsum(G * S)), `B` (the products) and `C` (dw, dr and dk);
- `block_us`: the mean and largest block time, and `kernel_us`, the span
  from the first block's start to the last one's end (globaltimer);
- `wave_starts_us`: when every 264th block started;
- the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rwkv6_bwd as k_wb

SLOTS = 32                      # stamps a block
KERNEL = "rwkv6_bwd_chunk_kernel(const"
HEAD = "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
TAIL = ("  if (tid < D) du_part[((int64_t)bh * nc + c) * D + tid] = "
        "du_acc;\n")


def _timer(slot: str) -> str:
    """CUDA lines: thread 0 writes %globaltimer into its block's `slot`."""
    return ("    long long t;\n"
            '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
            f"    g_stamps[blockIdx.x * {SLOTS} + {slot}] = t;\n")


def stamped(src: str, max_blocks: int) -> str:
    """The source with the stamps added to the chunk kernel."""
    a, b = src.find(KERNEL), src.find("// ---- launch 3")
    body = src[a:b]
    for marker in (HEAD, TAIL, "__syncthreads();"):
        if a < 0 or b < 0 or marker not in body \
                or '#include "wkv_subchunk.cuh"' not in src:
            raise SystemExit("wkv_bwd_stages: the kernel no longer holds "
                             f"{marker!r}")
    decl = (f"__device__ long long g_stamps[{max_blocks * SLOTS}];\n"
            'extern "C" int stamps_copy(void* dst, int n) {\n'
            "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n);\n}\n")
    body = body.replace(
        "__syncthreads();",
        f"__syncthreads(); if (tid == 0) g_stamps[blockIdx.x * {SLOTS} + "
        f"(stamp++ & {SLOTS - 1})] = clock64();")
    body = body.replace(
        HEAD, HEAD + "  int stamp = 2;\n  if (tid == 0) {\n" + _timer("0")
        + f"    g_stamps[blockIdx.x * {SLOTS} + 1] = clock64();\n  }}\n", 1)
    body = body.replace(
        TAIL, TAIL + "  if (tid == 0) {\n" + _timer(str(SLOTS - 1))
        + f"    g_stamps[blockIdx.x * {SLOTS} + {SLOTS - 2}] = stamp;\n  }}\n")
    include = '#include "wkv_subchunk.cuh"\n'
    src = src[:a] + body + src[b:]
    return src.replace(include, include + decl, 1)


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("wkv_bwd_stages: needs a CUDA card")
    b, ell, h, d = 2, 2048, 40, 64
    pl = k_wb.plan(b, ell, h, d)
    out = _build.BUILD_DIR.parent / "wkv_bwd_stages"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "stamped.cu", out / "stamped.so"
    cu.write_text(stamped((_build.CSRC / "rwkv6_bwd_chunked.cu").read_text(),
                          pl.chunk_grid))
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-shared", "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"wkv_bwd_stages: nvcc failed:\n{res.stdout}"
                         f"{res.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.rwkv6_bwd_chunked_launch
    fn.argtypes, fn.restype = k_wb._CHUNKED_ARGTYPES, ctypes.c_int
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn():
        return torch.randn(b, ell, h, d, generator=g, device=dev)

    r, k, v, do = ((0.5 * randn()).bfloat16() for _ in range(4))
    w = torch.exp(-torch.exp(-6.0 + 0.5 * randn()))
    u = 0.5 * torch.randn(h, d, generator=g, device=dev)
    shapes = k_wb.chunked_scratch_shapes(b, ell, h, d)
    states = torch.empty(shapes["states"], device=dev)
    du_part = torch.empty(shapes["du_part"], device=dev)
    grads = [torch.empty_like(t) for t in (r, r, r, w, u)]
    for _ in range(3):
        _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        w.data_ptr(), u.data_ptr(), do.data_ptr(),
                        *(t.data_ptr() for t in grads), du_part.data_ptr(),
                        states.data_ptr(), b, ell, h, d, pl.states_grid,
                        pl.chunk_grid, pl.threads, pl.states_smem, pl.smem,
                        torch.cuda.current_stream().cuda_stream),
                     "stamped rwkv6_bwd (chunked)")
    torch.cuda.synchronize()
    want = k_wb.wkv_bwd(r, k, v, w, u, do, route="chunked")
    if not all(torch.equal(x, y) for x, y in zip(grads, want)):
        raise SystemExit("wkv_bwd_stages: the stamped copy's gradients are "
                         "not the library's")
    buf = np.zeros(pl.chunk_grid * SLOTS, np.int64)
    _build.check(lib.stamps_copy(buf.ctypes.data_as(ctypes.c_void_p),
                                 ctypes.c_int(buf.nbytes)), "stamps_copy")
    s = buf.reshape(pl.chunk_grid, SLOTS)
    n = int(s[0, SLOTS - 2])
    cycles = np.diff(s[:, 1:n], axis=1).mean(0)
    names = ["load", "E", "G chain"] + [
        f"{q} {x}" for q in range(pl.chunk // pl.sub) for x in "ABC"]
    start, end = s[:, 0], s[:, SLOTS - 1]
    result = {
        "stage_cycles": dict(zip(names, (round(float(x)) for x in cycles))),
        "block_us": {"mean": float((end - start).mean() / 1e3),
                     "max": float((end - start).max() / 1e3)},
        "kernel_us": float((end.max() - start.min()) / 1e3),
        "wave_starts_us": [float((x - start.min()) / 1e3)
                           for x in np.sort(start)[::264]],
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()}
    print("wkv_bwd_stages " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
