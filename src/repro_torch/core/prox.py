"""Proximal operators for regularized multi-task learning (port of
`core/prox.py`).

The server's backward step is prox_{eta*lambda*g} over the (d, T) iterate.
Registry keys match the reference (MALSAR formulations):

  nuclear      - shared subspace learning, ||W||_*  (SVT; randomized SVT
                 through the `gauss_sketch` and `svt_reconstruct` kernels)
  l21          - joint feature learning, sum_i ||w^i||_2  (the `l21_prox`
                 kernel)
  l1           - elementwise sparsity
  elastic_net  - l1 + ridge
  ridge        - squared Frobenius
  none         - identity

The QR of the sketch, the SVD of the small (p, T) core and the products
around them stay with torch.linalg/torch.matmul, as the reference leaves
them to XLA.  The rank-distributed SVT (`ProxPlan`,
`svt_randomized_dist`) arrives with the sharded slice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.distributed.sharding import gather_columns, sum_partials
from repro_torch.kernels import ops
from repro_torch.kernels.ref import to_f32

Tensor = torch.Tensor


class Regularizer(NamedTuple):
    """A non-smooth penalty g with its proximal mapping."""

    name: str
    value: Callable[[Tensor], Tensor]
    prox: Callable[[Tensor, float], Tensor]
    separable_rows: bool  # prox decomposes over rows of W
    separable_cols: bool  # prox decomposes over columns (tasks)


# ---------------------------------------------------------------------------
# nuclear norm: singular value thresholding (paper Eq. IV.2)
# ---------------------------------------------------------------------------

def nuclear_value(w: Tensor) -> Tensor:
    return torch.sum(torch.linalg.svdvals(w.to(torch.float32)))


def svt(w: Tensor, t: float) -> Tensor:
    """Singular value thresholding: U (Sigma - t)_+ V^T."""
    u, s, vt = torch.linalg.svd(w.to(torch.float32), full_matrices=False)
    s = torch.clamp(s - to_f32(t), min=0.0)
    return (u * s[None, :] @ vt).to(w.dtype)


def sketch_width(rank: int, d: int, num_tasks: int) -> int:
    """Columns of the Halko sketch: `rank` + oversampling, clipped to the
    matrix."""
    return min(rank + 8, min(d, num_tasks))


def _sketch_seed(key) -> int:
    """uint32 counter seed of one refresh's sketch, from the folded key."""
    return prng.bits(key)


def svt_randomized(w: Tensor, t: float, *, rank: int, key) -> Tensor:
    """Randomized SVT: Halko range finder at `rank` + oversampling.

    `key` is the raw uint32[2] key the reference folds off its chain
    (`fold_in(key, 7)`); the sketch's Omega is counter-generated from the
    seed drawn off it and never materialized on the card
    (`ops.gauss_sketch`).  The reconstruction (Q U_b) * sigma @ V^T is
    `ops.svt_reconstruct`.
    """
    d, num_t = w.shape
    p = sketch_width(rank, d, num_t)
    w32 = w.to(torch.float32).contiguous()
    y = ops.gauss_sketch(w32, _sketch_seed(key), 0, p)       # (d, p)
    q, _ = torch.linalg.qr(y)                                # (d, p)
    b = q.T @ w32                                            # (p, T)
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    s = torch.clamp(s - to_f32(t), min=0.0)
    return ops.svt_reconstruct((q @ ub).contiguous(), s.contiguous(),
                               vt.contiguous()).to(w.dtype)


class ProxPlan(NamedTuple):
    """Collective schedule of the rank-distributed randomized SVT.

    The T task columns of the iterate are split over the mesh's ranks,
    `n_local = T / n_shards` columns a rank.  One refresh moves

      sum of partials  (d, p)        y = sum_r W_r @ Omega_r
      gather           (p, n_local)  projected-core blocks b_r = Q^T W_r

    i.e. O(d*p + p*T) bytes in place of the replicated prox's O(d*T)
    gather of the iterate.  The QR of the (d, p) sketch and the SVD of the
    (p, T) core are replicated; the reconstruction of a rank's columns is
    its own.
    """
    num_tasks: int     # global T
    n_local: int       # T // n_shards columns a rank owns

    def comm_bytes_per_refresh(self, d: int, rank: int,
                               itemsize: int = 4) -> int:
        """Collective payload a refresh: the (d, p) summed partial plus
        the gathered (p, T) projected core."""
        p = sketch_width(rank, d, self.num_tasks)
        return (d * p + p * self.num_tasks) * itemsize


def svt_randomized_dist(w_local: Tensor, t: float, *, rank: int, key,
                        plan: ProxPlan, mesh=None) -> Tensor:
    """Rank-distributed randomized SVT of the (d, T) iterate whose (d,
    n_local) column block `w_local` this rank holds; returns the
    thresholded reconstruction of the same columns.

    Omega's entries are counter-generated from the seed drawn off `key`
    (the same folded key on every rank), so the rank's sketch at
    `row_offset = rank * n_local` generates exactly its row block of the
    serial `svt_randomized`'s Omega, and the summed partials are the
    serial contraction W @ Omega.  Then the QR, `b_loc = Q^T W_loc`, the
    (p, n_local) gather, the SVD, and `ops.svt_reconstruct` on the rank's
    columns of V^T (made contiguous for the kernel).

    At one rank (`mesh` None or of size 1) both collectives are the
    identity and every expression is the serial one's: the result is
    bitwise `svt_randomized(w, t)`.  At n > 1 ranks the sum regroups the
    sum over T, so the result agrees to float32 rounding, not bitwise.
    """
    d = w_local.shape[0]
    p = sketch_width(rank, d, plan.num_tasks)
    t_off = 0 if mesh is None else mesh.rank * plan.n_local
    w32 = w_local.to(torch.float32).contiguous()
    y = sum_partials(ops.gauss_sketch(w32, _sketch_seed(key), t_off, p),
                     mesh)                                   # (d, p)
    q, _ = torch.linalg.qr(y)                                # (d, p)
    b = gather_columns(q.T @ w32, mesh)                      # (p, T)
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    s = torch.clamp(s - to_f32(t), min=0.0)
    vt_loc = vt[:, t_off:t_off + plan.n_local].contiguous()
    return ops.svt_reconstruct((q @ ub).contiguous(), s.contiguous(),
                               vt_loc).to(w_local.dtype)


# ---------------------------------------------------------------------------
# l2,1 row-group soft threshold (joint feature learning)
# ---------------------------------------------------------------------------

def l21_value(w: Tensor) -> Tensor:
    return torch.sum(torch.linalg.vector_norm(w.to(torch.float32), dim=1))


def l21_prox(w: Tensor, t: float) -> Tensor:
    """Row-wise group soft-threshold: w^i * max(0, 1 - t/||w^i||_2), by
    `ops.l21_prox` (the `l21_prox` kernel on the card, its plain version
    `ref.l21_prox_ref` on the CPU)."""
    return ops.l21_prox(w.contiguous(), t)


# ---------------------------------------------------------------------------
# l1 / elastic net / ridge
# ---------------------------------------------------------------------------

def l1_value(w: Tensor) -> Tensor:
    return torch.sum(torch.abs(w.to(torch.float32)))


def l1_prox(w: Tensor, t: float) -> Tensor:
    w32 = w.to(torch.float32)
    return (torch.sign(w32)
            * torch.clamp(torch.abs(w32) - to_f32(t), min=0.0)).to(w.dtype)


def make_elastic_net(alpha: float = 1.0) -> Regularizer:
    """g(W) = ||W||_1 + (alpha/2)||W||_F^2 — the paper's strict-convexity fix."""

    def value(w: Tensor) -> Tensor:
        w32 = w.to(torch.float32)
        return torch.sum(torch.abs(w32)) + 0.5 * alpha * torch.sum(w32 * w32)

    def prox(w: Tensor, t: float) -> Tensor:
        denom = float(np.float32(1.0)
                      + np.float32(to_f32(t)) * np.float32(alpha))
        return (l1_prox(w, t).to(torch.float32) / denom).to(w.dtype)

    return Regularizer("elastic_net", value, prox, True, True)


def ridge_value(w: Tensor) -> Tensor:
    w32 = w.to(torch.float32)
    return 0.5 * torch.sum(w32 * w32)


def ridge_prox(w: Tensor, t: float) -> Tensor:
    return (w.to(torch.float32)
            / float(np.float32(1.0) + np.float32(to_f32(t)))).to(w.dtype)


def none_value(w: Tensor) -> Tensor:
    return torch.zeros((), dtype=torch.float32, device=w.device)


def none_prox(w: Tensor, t: float) -> Tensor:
    del t
    return w


REGISTRY: dict[str, Regularizer] = {
    "nuclear": Regularizer("nuclear", nuclear_value, svt, False, False),
    "l21": Regularizer("l21", l21_value, l21_prox, True, False),
    "l1": Regularizer("l1", l1_value, l1_prox, True, True),
    "elastic_net": make_elastic_net(),
    "ridge": Regularizer("ridge", ridge_value, ridge_prox, True, True),
    "none": Regularizer("none", none_value, none_prox, True, True),
}


def get_regularizer(name: str, **kwargs) -> Regularizer:
    if name == "elastic_net" and kwargs:
        return make_elastic_net(**kwargs)
    if name not in REGISTRY:
        raise KeyError(f"unknown regularizer {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def apply_prox(name: str, w: Tensor, t: float) -> Tensor:
    return get_regularizer(name).prox(w, t)
