"""Dispatch between the CUDA kernels and their plain PyTorch versions.

Port of `repro/kernels/ops.py`, with the device of the tensor in place of
`_on_tpu()`: a CPU tensor goes to the plain version in `ref`, a CUDA
tensor goes to the kernel, and anything else raises.  Nothing falls back:
a CUDA tensor reaches its kernel or an exception.

Each kernel module keeps an integer `launches`, raised by one at each
launch; `launch_counts` reads them and `reset_launch_counts` zeroes them,
so a run can show which kernels its path went through.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import amtl_event as _amtl_event
from repro_torch.kernels import amtl_event_batch as _amtl_event_batch
from repro_torch.kernels import gauss_sketch as _gauss_sketch
from repro_torch.kernels import ref
from repro_torch.kernels import svt_reconstruct as _svt_reconstruct

KERNELS = {
    "amtl_event": _amtl_event,
    "amtl_event_batch": _amtl_event_batch,
    "gauss_sketch": _gauss_sketch,
    "svt_reconstruct": _svt_reconstruct,
}


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{t.device}")


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def amtl_event(v_t: torch.Tensor, p_t: torch.Tensor, g_t: torch.Tensor,
               eta: float, eta_k: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused delta-ring column event: returns (v_new, undo-log entry)."""
    if _on_cuda("amtl_event", v_t):
        return _amtl_event.amtl_event(v_t, p_t, g_t, eta, eta_k)
    return ref.amtl_event_ref(v_t, p_t, g_t, eta, eta_k)


def amtl_event_batch(v: torch.Tensor, p_cols: torch.Tensor,
                     g_cols: torch.Tensor, tasks: torch.Tensor, eta: float,
                     eta_ks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched multi-event update of `v` IN PLACE: returns (v, undo (B, d)).

    Within-batch duplicate tasks serialize in event order; ids >= T are
    dropped (see `ref.amtl_event_batch_ref`).
    """
    if _on_cuda("amtl_event_batch", v):
        return _amtl_event_batch.amtl_event_batch(v, p_cols, g_cols, tasks,
                                                  eta, eta_ks)
    return ref.amtl_event_batch_ref(v, p_cols, g_cols, tasks, eta, eta_ks)


def gauss_sketch(w: torch.Tensor, seed: int, row_offset: int,
                 p: int) -> torch.Tensor:
    """(d, p) float32 randomized-SVT sketch W @ Omega."""
    if _on_cuda("gauss_sketch", w):
        return _gauss_sketch.gauss_sketch(w, seed, row_offset, p)
    return ref.gauss_sketch_ref(w, seed, row_offset, p)


def svt_reconstruct(qu: torch.Tensor, s: torch.Tensor,
                    vt: torch.Tensor) -> torch.Tensor:
    """Thresholded low-rank SVT apply (QU * sigma) @ V^T: (d, m)."""
    if _on_cuda("svt_reconstruct", qu):
        return _svt_reconstruct.svt_reconstruct(qu, s, vt)
    return ref.svt_reconstruct_ref(qu, s, vt)
