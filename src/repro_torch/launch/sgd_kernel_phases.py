"""Where the batch step's two kernels spend their time, on the card.

    PYTHONPATH=src python3 src/repro_torch/launch/sgd_kernel_phases.py

Builds variants of `csrc/lstsq_grad_sampled.cu` and
`csrc/amtl_event_batch.cu`, each with `nvcc` into its own library under
`build/sgd_kernel_phases/`, and times them on the card at the ragged SGD
batch step (32 events on 128 cohorts of 80..399 rows in a 399-row
buffer, d 8192, minibatch 32; V (8192, 128); CUDA events behind a device
sleep, median of 7 windows of 10 launches), at B 32 and B 1:

- `full`: the gradient kernel as it is (the chunk picked by residency);
- `wide`, `narrow`: the chunk forced to 16 or to 8 rows;
- `no_cluster_sum`: each CTA takes its own partial dot products for the
  whole (the cluster barrier and the distributed-shared-memory reads
  cut; its gradients are wrong, only its time is read);
- `resident_clusters`: how many 8-CTA clusters of each chunk width the
  card holds at once (cudaOccupancyMaxActiveClusters);
- `spans`: each kernel instrumented with %globaltimer at a block's start
  and end: the launch's span from the first block's start to the last
  block's end, and a block's median time;
- `amtl_event_batch columns`: the event batch storing each chain's last
  value straight to its column of V instead of writing the staged tile
  back whole (same bits; timed and spanned beside the kernel as it is);
- `launch_floor`: `sample_mask` at n 400, a kernel with next to no work.

Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import amtl_event_batch as k_batch
from repro_torch.kernels import lstsq_grad_sampled as k_sampled
from repro_torch.kernels import sample_mask as k_mask

D, T, N, B, SGD_BATCH = 8192, 128, 399, 32, 32
WIDE_IF = "  if (b <= resident) return launch_vr<V, kWide>(ev, b, stream);"
CLUSTER_SUM = (
    "      cluster.sync();\n      if (tid < cnt) {\n"
    "        float v = *cluster.map_shared_rank(&part[buf][tid], 0);\n"
    "        for (int q = 1; q < kCluster; ++q) {",
    "      __syncthreads();\n      if (tid < cnt) {\n"
    "        float v = part[buf][tid];\n"
    "        for (int q = 1; q < 1; ++q) {")
RESIDENT = """
extern "C" int resident_clusters(int narrow) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  int n = -1;
  const cudaError_t err = narrow
      ? cudaOccupancyMaxActiveClusters(&n, sampled_grad_kernel<1, 8>, &cfg)
      : cudaOccupancyMaxActiveClusters(&n, sampled_grad_kernel<1, 16>, &cfg);
  return err == cudaSuccess ? n : -1;
}
"""
SPAN_DECL = "namespace {\n\n__device__ unsigned long long g_span[2 * 65536];\n"
SPAN_START = ('\n  unsigned long long t0_;\n'
              '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0_));\n')
SPAN_END = ('\n  __syncthreads();\n  if (threadIdx.x == 0) {\n'
            '    unsigned long long t1_;\n'
            '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1_));\n'
            '    g_span[2 * blockIdx.x] = t0_;\n'
            '    g_span[2 * blockIdx.x + 1] = t1_;\n  }\n')
SPAN_READ = ('\nextern "C" int read_spans(unsigned long long* out, int n) {\n'
             '  return (int)cudaMemcpyFromSymbol(out, g_span, 16 * (size_t)n);'
             '\n}\n')
GRAD_START = "  cg::cluster_group cluster = cg::this_cluster();\n"
GRAD_END = "\n}\n\ntemplate <int V, int R>\nint launch_vr"
BATCH_START = "  const int warps = blockDim.x >> 5;\n"
BATCH_END = "\n}\n\n}  // namespace"
TILE_STORE = "      if (kept) vs[r * vst + t] = cur;\n"
TILE_WRITE_BACK = (
    "  __syncthreads();\n  for (int r = warp; r < nr; r += warps) {\n"
    "    uint32_t* vrow = v + (size_t)(row0 + r) * num_t;\n"
    "    for (int c = lane; c < num_t; c += 32) vrow[c] = vs[r * vst + c];\n"
    "  }\n")
COLUMN_STORE = (
    (TILE_STORE,
     "      if (kept) v[(size_t)(row0 + r) * num_t + t] = cur;\n"),
    (TILE_WRITE_BACK, ""))


def cut(src: str, *edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"sgd_kernel_phases: the kernel no longer holds "
                             f"{old!r}")
        src = src.replace(old, new, 1)
    return src


def spanned(src: str, start: str, end: str) -> str:
    """`src` with each block's start and end times recorded."""
    return cut(src, ("namespace {\n", SPAN_DECL),
               (start, start + SPAN_START),
               (end, SPAN_END + end[1:])) + SPAN_READ


def variants() -> dict[str, str]:
    grad = (_build.CSRC / "lstsq_grad_sampled.cu").read_text()
    batch = (_build.CSRC / "amtl_event_batch.cu").read_text()
    return {"full": grad + RESIDENT,
            "wide": cut(grad, (WIDE_IF, WIDE_IF.replace(
                "if (b <= resident) ", ""))),
            "narrow": cut(grad, (WIDE_IF, "")),
            "no_cluster_sum": cut(grad, CLUSTER_SUM),
            "grad_spans": spanned(grad, GRAD_START, GRAD_END),
            "batch_spans": spanned(batch, BATCH_START, BATCH_END),
            "batch_columns_spans": spanned(cut(batch, *COLUMN_STORE),
                                           BATCH_START, BATCH_END)}


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    out = _build.BUILD_DIR.parent / "sgd_kernel_phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"sgd_kernel_phases: nvcc failed for {name}:\n"
                             f"{log}")
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


def spans(lib: ctypes.CDLL, blocks: int, call, reps: int = 5) -> dict:
    """Median over `reps` launches of the span and of a block's time, us."""
    call()
    torch.cuda.synchronize()
    span, block = [], []
    for _ in range(reps):
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (2 * blocks))()
        _build.check(lib.read_spans(buf, blocks), "read_spans")
        t = np.asarray(buf, np.int64).reshape(blocks, 2)
        span.append((t[:, 1].max() - t[:, 0].min()) / 1e3)
        block.append(float(np.median(t[:, 1] - t[:, 0])) / 1e3)
    return {"span_us": statistics.median(span),
            "block_us": statistics.median(block)}


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("sgd_kernel_phases: needs a CUDA card")
    libs = build(variants())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    n_ts = rng.integers(80, N + 1, T)
    tasks = rng.integers(0, T, B)
    xs = torch.randn(T, N, D, generator=gen, device=dev)
    ys = torch.randn(T, N, generator=gen, device=dev)
    w = torch.randn(B, D, generator=gen, device=dev)
    ts = torch.as_tensor(tasks, dtype=torch.int32, device=dev)
    scal = torch.from_numpy(ref.sample_scalars(
        N, SGD_BATCH, rng.integers(0, 2**32, B, dtype=np.uint64),
        n_ts[tasks])).to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for name in ("full", "wide", "narrow", "no_cluster_sum", "grad_spans"):
        fn = libs[name].lstsq_grad_sampled_batch_launch
        fn.argtypes, fn.restype = k_sampled._BATCH_ARGTYPES, ctypes.c_int
        for b in (B, 1):
            g = torch.empty((b, D), device=dev)

            def call(fn=fn, b=b, g=g):
                _build.check(fn(xs.data_ptr(), ys.data_ptr(), ts.data_ptr(),
                                w.data_ptr(), scal.data_ptr(), SGD_BATCH,
                                g.data_ptr(), T, N, D, b, stream), name)
            key = f"{name} B {b}"
            result[key] = (spans(libs[name], 8 * b, call)
                           if name == "grad_spans" else device_us(call))
    full = libs["full"]
    result["resident_clusters"] = {"wide": full.resident_clusters(0),
                                   "narrow": full.resident_clusters(1)}
    v = torch.randn(D, T, generator=gen, device=dev)
    p, gc = (torch.randn(D, B, generator=gen, device=dev) for _ in range(2))
    eks = torch.rand(B, generator=gen, device=dev)
    undo = torch.empty((B, D), device=dev)
    for mode, lib in (("tile", "batch_spans"),
                      ("columns", "batch_columns_spans")):
        fn = libs[lib].amtl_event_batch_launch
        fn.argtypes, fn.restype = k_batch._ARGTYPES, ctypes.c_int

        def call(fn=fn):
            _build.check(fn(v.data_ptr(), p.data_ptr(), gc.data_ptr(),
                            ts.data_ptr(), eks.data_ptr(), 0.05,
                            undo.data_ptr(), D, T, B, stream),
                         "amtl_event_batch")
        result[f"amtl_event_batch {mode}"] = dict(
            spans(libs[lib], D // 32, call), us=device_us(call))
    block = ref.sample_scalars(400, SGD_BATCH, [77], [240])[0]
    result["launch_floor_us"] = device_us(
        lambda: k_mask.sample_mask(400, block, dev))
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print("sgd_kernel_phases " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
