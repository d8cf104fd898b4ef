"""Build and load the port's CUDA kernels.

Each source in `repro_torch/csrc/*.cu` is compiled by its own `nvcc`
process, all started together, and one more `nvcc` links the objects into
a shared library with a plain C interface, loaded with `ctypes`.  The
library lands in `build/repro_torch_kernels/` at the repository root,
named by a hash of the sources, the shared headers (`csrc/*.cuh`) and the
flags, so an unchanged tree reuses it and a changed one, a header
included, rebuilds.  Nothing is built when a module is imported: the
first kernel launch builds.

Every C entry point returns `cudaGetLastError()` after its launch, and
`check` raises on anything but 0, so a refused launch (too many threads,
too much shared memory, no kernel image for the card) is never silent.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import operator
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "on this machine")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the kernels if needed; returns (library, seconds spent).

    `verbose` adds `-Xptxas -v` and prints the compiler's report of each
    kernel's registers, shared memory and spills.
    """
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        obj = tmp.with_name(f"{src.stem}.{os.getpid()}.o")
        cmd = [nvcc(), *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    reports = [(cmd, proc.communicate()[0], proc.returncode)
               for cmd, proc in procs]
    link = [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    if all(rc == 0 for _, _, rc in reports):
        res = subprocess.run(link, capture_output=True, text=True)
        reports.append((link, res.stdout + res.stderr, res.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    for cmd, text, rc in reports:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    if verbose:
        print("".join(text for _, text, _ in reports), flush=True)
    os.replace(tmp, out)       # atomic: a concurrent build never sees half a file
    return out, secs


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _ = build()
        _lib = ctypes.CDLL(str(path))
    return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    fn = getattr(load(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")


def stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device: torch.device) -> int:
    """The number of SMs of the card `device`, which the launch plans
    size their grids by."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _sm_count(index)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def require_cuda(name: str, **tensors: torch.Tensor) -> torch.device:
    """Check that every tensor is a contiguous float32/int32 CUDA tensor on
    one device; returns that device."""
    dev = None
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
    return dev


def require_dtype(name: str, dtype: torch.dtype, **tensors: torch.Tensor):
    for arg, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")


def require_f32(name: str, **tensors: torch.Tensor) -> torch.device:
    """Check that every tensor is a contiguous float32 tensor, all on one
    device, whichever it is; returns that device."""
    dev = None
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: {arg} must be a tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be torch.float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
    return dev


def host_index(name: str, arg: str, i, size: int) -> int:
    """A host integer index checked to lie in [0, size)."""
    try:
        i = operator.index(i)
    except TypeError:
        raise ValueError(f"{name}: {arg} must be a host integer, got "
                         f"{type(i).__name__}") from None
    if not 0 <= i < size:
        raise ValueError(f"{name}: {arg} = {i} is outside [0, {size})")
    return i


def amtl_event_inplace_args(v: torch.Tensor, t, p_t: torch.Tensor,
                            g_t: torch.Tensor, ring: torch.Tensor,
                            slot) -> tuple[int, int]:
    """The checked (t, slot) of an in-place column event on a contiguous
    float32 (d, T) iterate v and (depth, d) ring, with (d,) p_t and g_t,
    all on one device; raises ValueError on anything else.  The kernel's
    wrapper and the plain version both check their arguments here."""
    name = "amtl_event_inplace"
    require_f32(name, v=v, p_t=p_t, g_t=g_t, ring=ring)
    d = v.shape[0] if v.dim() == 2 else -1
    if d < 0 or ring.dim() != 2 or ring.shape[1] != d \
            or p_t.shape != (d,) or g_t.shape != (d,):
        raise ValueError(f"{name} expects v (d, T), p_t and g_t (d,), ring "
                         f"(depth, d); got {tuple(v.shape)}, "
                         f"{tuple(p_t.shape)}, {tuple(g_t.shape)}, "
                         f"{tuple(ring.shape)}")
    return (host_index(name, "t", t, v.shape[1]),
            host_index(name, "slot", slot, ring.shape[0]))


def km_update_slot_args(ring: torch.Tensor, src, dst, t, p_t: torch.Tensor,
                        g_t: torch.Tensor) -> tuple[int, int, int]:
    """The checked (src, dst, t) of a slot update on a contiguous float32
    (depth, d, T) ring with (d,) p_t and g_t, all on one device, a slot
    under 2^31 elements; raises ValueError on anything else.  The
    kernel's wrapper and the plain version both check their arguments
    here."""
    name = "km_update_slot"
    require_f32(name, ring=ring, p_t=p_t, g_t=g_t)
    d = ring.shape[1] if ring.dim() == 3 else -1
    if d < 0 or p_t.shape != (d,) or g_t.shape != (d,):
        raise ValueError(f"{name} expects ring (depth, d, T), p_t and g_t "
                         f"(d,); got {tuple(ring.shape)}, "
                         f"{tuple(p_t.shape)}, {tuple(g_t.shape)}")
    depth, _, num_t = ring.shape
    if d * num_t >= 2 ** 31:
        raise ValueError(f"{name}: a slot of {d} x {num_t} elements is not "
                         "under 2^31")
    return (host_index(name, "src", src, depth),
            host_index(name, "dst", dst, depth),
            host_index(name, "t", t, num_t))


def host_scalar(name: str, x) -> float:
    """A Python float from a number or a CPU scalar (no device sync)."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        raise ValueError(f"{name}: scalar must be a host number, not a "
                         f"{x.device} tensor")
    return float(x)


def scalar_block(name: str, scalars) -> tuple[int, int, int, int]:
    """The four uint32 (seed, cut_h, cut_i, n_t) of an event's scalar block,
    as Python ints, from host values (a sequence or a numpy row)."""
    vals = [int(s) for s in scalars]
    if len(vals) != 4 or any(not 0 <= s <= 0xFFFFFFFF for s in vals):
        raise ValueError(f"{name}: the scalar block is four uint32 (seed, "
                         f"cut_h, cut_i, n_t); got {vals}")
    return vals[0], vals[1], vals[2], vals[3]


def lstsq_shapes(name: str, x: torch.Tensor, w: torch.Tensor,
                 y: torch.Tensor) -> tuple[int, int]:
    """(n, d) of a least-squares gradient's X (n, d), w (d,), y (n,)."""
    if x.dim() != 2 or w.shape != (x.shape[1],) or y.shape != (x.shape[0],):
        raise ValueError(f"{name} expects x (n, d), w (d,), y (n,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(y.shape)}")
    return x.shape[0], x.shape[1]
