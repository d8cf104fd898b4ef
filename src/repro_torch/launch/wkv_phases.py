"""Where the chunked WKV kernel's time goes: its phases cut out in turn.

    PYTHONPATH=src python3 src/repro_torch/launch/wkv_phases.py

Builds variants of `csrc/rwkv6_chunked.cu`, each with `nvcc` into its own
library under `build/wkv_phases/`, and times each on the card at the
rwkv6-3b prefill (B 2, L 5000, H 40, D 64, bf16; CUDA events behind a
device sleep, median of 7 windows of 10 launches):

- `full`: the kernel as it is;
- `no_decays`: phase 1 (the running products and scaled rows) cut;
- `no_scores`: phase 2 (the score blocks) cut;
- `no_products`: phase 3 (the product warps' mmas and the state steps)
  cut;
- `loads_only`: all three cut: the cp.async ring and the barriers;
- `s_one_term`: the product warps take S as one TF32 term (the lo term's
  8 bf16 mmas a sub-chunk cut).

A cut phase leaves its outputs unwritten, so a variant's results are
wrong; only its time is read.  Prints one JSON line with each variant's
microseconds and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rwkv6_scan as k_rwkv

DECAYS = ("    {\n      const int q = warp % NSUB, r0 = q * SUB, c2 = 2 * lane;",
          "    if (false) {\n      const int q = warp % NSUB, r0 = q * SUB, "
          "c2 = 2 * lane;")
SCORES = [("    if (warp < NSUB)\n      scores_across(",
           "    if (false)\n      scores_across("),
          ("    else {\n      const int q = warp - NSUB;",
           "    else if (false) {\n      const int q = warp - NSUB;")]
PRODUCTS = ("      const int nq = min(NSUB, (L - t0 + SUB - 1) / SUB);",
            "      const int nq = 0;")
S_LO = ("            mma_bf16(ob[jn], a0, a1, a2, a3, lo[0], lo[1]);\n", "")


def cut(src: str, *edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"wkv_phases: the kernel no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict[str, str]:
    return {"full": src,
            "no_decays": cut(src, DECAYS),
            "no_scores": cut(src, *SCORES),
            "no_products": cut(src, PRODUCTS),
            "loads_only": cut(src, DECAYS, *SCORES, PRODUCTS),
            "s_one_term": cut(src, S_LO)}


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    out = _build.BUILD_DIR.parent / "wkv_phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"wkv_phases: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def device_us(fn, reps: int = 7, inner: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner * 1e3)
    return statistics.median(times)


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("wkv_phases: needs a CUDA card")
    src = (_build.CSRC / "rwkv6_chunked.cu").read_text()
    libs = build(variants(src))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    b, ell, h, d = 2, 5000, 40, 64

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    r, k, v = ((0.5 * randn(b, ell, h, d)).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + 0.5 * randn(b, ell, h, d)))
    u, state = 0.5 * randn(h, d), torch.zeros(b, h, d, d, device=dev)
    out = torch.empty_like(r)
    pl = k_rwkv.plan(b, ell, h, d)
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for name, lib in libs.items():
        fn = lib.rwkv6_chunked_launch
        fn.argtypes, fn.restype = k_rwkv._CHUNKED_ARGTYPES, ctypes.c_int

        def call():
            _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                            w.data_ptr(), u.data_ptr(), state.data_ptr(),
                            out.data_ptr(), b, ell, h, d, pl.grid,
                            pl.threads, pl.smem, stream), name)
        result[name] = device_us(call)
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print("wkv_phases " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
