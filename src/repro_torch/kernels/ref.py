"""Plain PyTorch versions of the kernels on the engine path.

Each function is the semantic ground truth for its CUDA kernel and the
port of the function of the same name in the reference package's
`kernels/ref.py`.  They run on any device; `ops` sends CPU tensors here.

The KM update is written as the two fused multiply-adds that XLA's CPU
backend emits for `v + eta_k*(p - eta*g - v)`:

    fma(eta_k, fma(-eta, g, p) - v, v)

so that the port reproduces the reference's float32 bits.  PyTorch has no
fma, so `_fma32` forms it exactly: the product of two float32 values is
exact in float64, the float64 sum is rounded to odd, and rounding that to
float32 then equals one correctly rounded fma.  The CUDA kernels write the
same two `__fmaf_rn` calls.
"""
from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF


def to_f32(x) -> float:
    """A Python number rounded to the nearest float32 value."""
    return float(np.float32(float(x)))


def _fma32(a: Tensor | float, b: Tensor, c: Tensor) -> Tensor:
    """float32 fma(a, b, c) = round(a*b + c) with a single rounding.

    All operands are float32 values.  a*b is exact in float64; the sum is
    rounded to odd (TwoSum error, then a one-ulp step towards it when the
    float64 result is even), which makes the final float32 rounding the
    correct one.
    """
    a64 = torch.as_tensor(a, dtype=torch.float32).to(torch.float64)
    s = a64 * b.to(torch.float64)
    c64 = c.to(torch.float64)
    r = s + c64
    bb = r - s
    err = (s - (r - bb)) + (c64 - bb)
    even = (r.view(torch.int64) & 1) == 0
    step = torch.where(err > 0, torch.full_like(r, math.inf),
                       torch.full_like(r, -math.inf))
    r = torch.where((err != 0) & even, torch.nextafter(r, step), r)
    return r.to(torch.float32)


def km_update_ref(v: Tensor, p: Tensor, g: Tensor, eta: float,
                  eta_k: float) -> Tensor:
    """Fused AMTL update (paper Eq. III.4): v + eta_k*(p - eta*g - v)."""
    a = _fma32(-to_f32(eta), g.to(torch.float32), p.to(torch.float32))
    return _fma32(to_f32(eta_k), a - v, v.to(torch.float32)).to(v.dtype)


def amtl_event_ref(v_t: Tensor, p_t: Tensor, g_t: Tensor, eta: float,
                   eta_k: float) -> tuple[Tensor, Tensor]:
    """Fused delta-ring column event: (Eq. III.4 update, undo-log entry).

    The second output is a copy of the exact pre-write bits of v_t.
    """
    return km_update_ref(v_t, p_t, g_t, eta, eta_k), v_t.clone()


def last_occurrence_mask(tasks: Tensor) -> Tensor:
    """(B,) bool: event i is the LAST in-batch occurrence of its task."""
    idx = torch.arange(tasks.shape[0], device=tasks.device)
    later_dup = ((tasks[None, :] == tasks[:, None])
                 & (idx[None, :] > idx[:, None]))
    return ~torch.any(later_dup, dim=1)


def amtl_event_batch_ref(v: Tensor, p_cols: Tensor, g_cols: Tensor,
                         tasks: Tensor, eta: float,
                         eta_ks: Tensor) -> tuple[Tensor, Tensor]:
    """Batched fused column events, serialized in event order, IN PLACE.

    v: (d, T) iterate, updated in place and returned; p_cols/g_cols: (d, B);
    tasks: (B,) ids; eta_ks: (B,).  Returns (v, undo (B, d)).

    Event i reads its task's column as left by the earlier events of the
    batch, records that column as its undo entry, and writes its update
    back.  An id >= T is dropped (the sharded engine's sentinel): it never
    writes v, and its undo entry is what the reference's clamped gather
    gives, the pre-batch column T-1, or the output of the latest earlier
    event with the same id.
    """
    d, num_t = v.shape
    ids = [int(t) for t in tasks.tolist()]
    if any(t < 0 for t in ids):
        raise ValueError(f"task ids must be >= 0, got {ids}")
    ks = eta_ks.tolist()
    last_col = v[:, num_t - 1].clone()
    dropped: dict[int, Tensor] = {}
    undo = torch.empty((len(ids), d), dtype=v.dtype, device=v.device)
    for i, t in enumerate(ids):
        cur = v[:, t] if t < num_t else dropped.get(t, last_col)
        undo[i] = cur
        out = km_update_ref(undo[i], p_cols[:, i], g_cols[:, i], eta, ks[i])
        if t < num_t:
            v[:, t] = out
        else:
            dropped[t] = out
    return v, undo


def svt_reconstruct_ref(qu: Tensor, s: Tensor, vt: Tensor) -> Tensor:
    """Thresholded low-rank apply: (QU * sigma) @ V^T, in float32."""
    qu32 = qu.to(torch.float32)
    return ((qu32 * s.to(torch.float32)[None, :])
            @ vt.to(torch.float32)).to(qu.dtype)


# ------------------------------------------------ counter-based normals ---
#
# uint32 arithmetic in int64 tensors: every product is split so that it
# stays below 2**63, and every result is masked back to 32 bits.

def _mul32(x: Tensor, c: int) -> Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def counter_hash(seed: int, ctr: Tensor) -> Tensor:
    """uint32 lowbias32 hash of (seed, counter), as int64 in [0, 2**32)."""
    x = _mul32(ctr.to(torch.int64) & _M32, 0x9E3779B9) ^ (int(seed) & _M32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def gauss_from_counters(seed: int, ctr: Tensor) -> Tensor:
    """float32 standard normals from uint32 counters (Box-Muller)."""
    c2 = (ctr.to(torch.int64) * 2) & _M32
    u1 = counter_hash(seed, c2)
    u2 = counter_hash(seed, (c2 + 1) & _M32)
    f1 = ((u1 >> 8).to(torch.float32) + 1.0) * (2.0 ** -24)
    f2 = (u2 >> 8).to(torch.float32) * (2.0 ** -24)
    two_pi = torch.tensor(2.0 * 3.141592653589793, dtype=torch.float32)
    return torch.sqrt(-2.0 * torch.log(f1)) * torch.cos(two_pi * f2)


def gauss_omega_ref(rows: int, p: int, seed: int, row_offset: int = 0,
                    device: torch.device | str = "cpu") -> Tensor:
    """(rows, p) float32 block of the counter-generated sketch Omega.

    Entry (r, c) is gauss_from_counters(seed, (row_offset + r) * p + c).
    """
    r_idx = (row_offset + torch.arange(rows, dtype=torch.int64,
                                       device=device))[:, None]
    c_idx = torch.arange(p, dtype=torch.int64, device=device)[None, :]
    return gauss_from_counters(seed, (r_idx * p + c_idx) & _M32)


def gauss_sketch_ref(w: Tensor, seed: int, row_offset: int, p: int) -> Tensor:
    """(d, p) float32 sketch W @ Omega with Omega materialized."""
    omega = gauss_omega_ref(w.shape[1], p, seed, row_offset, w.device)
    return w.to(torch.float32) @ omega
