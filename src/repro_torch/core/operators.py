"""Operator-splitting building blocks (port of `core/operators.py`).

Forward operator   F = I - eta * grad(f)          (separable across tasks)
Backward operator  B = (I + eta*lam*dg)^{-1}      (= prox, NOT separable)

Backward-forward V+ = F(B(V)) is the paper's reordering: the outer operator
is separable, so a single task block of V can be updated (Eq. III.4).

The undo-log rollbacks are pure data movement.  Which ring entry restores
which column depends only on the task ring, the ring pointer and the
staleness, all of which the engines keep on the host, so the selection is
made in numpy (`rollback_winners`) and the device does one column scatter.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.losses import MTLProblem
from repro_torch.core.prox import get_regularizer
from repro_torch.kernels import ops

Tensor = torch.Tensor


class SplittingConfig(NamedTuple):
    eta: float        # gradient / prox step (0, 2/L)
    lam: float        # regularization weight
    reg_name: str


def backward(problem: MTLProblem, v: Tensor, eta: float) -> Tensor:
    """prox_{eta*lam*g}(V)."""
    return get_regularizer(problem.reg_name).prox(v, eta * problem.lam)


def forward(problem: MTLProblem, w: Tensor, eta: float) -> Tensor:
    """(I - eta * grad f)(W) — separable per task column."""
    return w - eta * problem.full_grad(w)


def forward_backward(problem: MTLProblem, w: Tensor, eta: float) -> Tensor:
    """One synchronous proximal-gradient step (SMTL inner map)."""
    return backward(problem, forward(problem, w, eta), eta)


def backward_forward(problem: MTLProblem, v: Tensor, eta: float) -> Tensor:
    """V+ = (I - eta grad f)(prox(V)) — the paper's reordered iteration."""
    return forward(problem, backward(problem, v, eta), eta)


def km_step(v: Tensor, op_v: Tensor, eta_k: float) -> Tensor:
    """Krasnosel'skii-Mann relaxation: v + eta_k (Op(v) - v)."""
    return v + eta_k * (op_v - v)


def km_block_update(v_t: Tensor, prox_t: Tensor, grad_t: Tensor,
                    eta: float, eta_k: float) -> Tensor:
    """Paper Eq. III.4 — the fused per-task-block AMTL update, in the fma
    form, by `ops.km_update` (the `km_update` kernel on the card,
    `ref.km_update_ref` on the CPU); the operands are contiguous."""
    return ops.km_update(v_t, prox_t, grad_t, eta, eta_k)


def rollback_columns(v: Tensor, delta_ring: Tensor, task_ring, ptr: int,
                     nu: int, tau: int) -> Tensor:
    """The iterate from `nu` events ago, rebuilt from the undo log.

    `delta_ring[s]` holds the exact pre-write bits of column `task_ring[s]`
    at the event written to slot `s`; `ptr` is the newest event's slot.
    Restoring the `nu` newest entries newest-first gives the dense ring's
    `ring[ptr - nu]` bitwise.  This is the sequential reference; returns a
    new tensor.
    """
    out = v.clone()
    depth = tau + 1
    tasks = np.asarray(task_ring)
    for j in range(min(int(nu), tau)):
        slot = (int(ptr) - j) % depth
        out[:, int(tasks[slot])] = delta_ring[slot]
    return out


def rollback_winners(task_ring, ptr: int, nu: int, tau: int,
                     t_offset: int = 0,
                     n_local: int | None = None) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """(local columns, ring slots) that one scatter must restore.

    The newest-first replay ends with the OLDEST active entry per column
    winning, so each column touched inside the window restores from the
    entry with the largest offset j < nu.  Entries whose task lies outside
    [t_offset, t_offset + n_local) are dropped.  Winners have distinct
    columns, so the scatter is deterministic.
    """
    depth = tau + 1
    j = np.arange(tau)                              # j=0 -> newest event
    slots = (int(ptr) - j) % depth
    tasks = np.asarray(task_ring).astype(np.int64)[slots]
    active = j < int(nu)
    same = tasks[None, :] == tasks[:, None]
    older = j[None, :] > j[:, None]
    shadowed = np.any(same & older & active[None, :], axis=1)
    local = tasks - int(t_offset)
    owned = local >= 0
    if n_local is not None:
        owned &= local < n_local
    win = active & ~shadowed & owned
    return local[win], slots[win]


def restore_columns(v: Tensor, delta_ring: Tensor, cols: Tensor,
                    slots: Tensor) -> Tensor:
    """A copy of `v` with columns `cols` set to ring entries `slots`."""
    out = v.clone()
    if cols.numel():
        out.index_copy_(1, cols, delta_ring.index_select(0, slots).T)
    return out


def rollback_columns_shard(v: Tensor, delta_ring: Tensor, task_ring,
                           ptr: int, nu: int, tau: int,
                           t_offset: int) -> Tensor:
    """Shard-local rollback: `task_ring` holds GLOBAL task ids and `v` is
    the (d, T_local) block of columns [t_offset, t_offset + T_local).

    Bitwise equal to the sequential replay restricted to the block.
    """
    if tau == 0:
        return v.clone()
    cols, slots = rollback_winners(task_ring, ptr, nu, tau, t_offset,
                                   v.shape[1])
    dev = v.device
    return restore_columns(v, delta_ring, torch.as_tensor(cols, device=dev),
                           torch.as_tensor(slots, device=dev))


def rollback_columns_batch(v: Tensor, delta_ring: Tensor, task_ring,
                           ptr: int, nu: int, tau: int) -> Tensor:
    """Vectorized multi-column rollback: one scatter of the winners,
    bitwise equal to `rollback_columns` (the t_offset=0 shard)."""
    return rollback_columns_shard(v, delta_ring, task_ring, ptr, nu, tau, 0)


def fixed_point_residual(problem: MTLProblem, v: Tensor, eta: float) -> Tensor:
    """||BF(v) - v||_F — zero exactly at a fixed point of the BF operator."""
    return torch.linalg.vector_norm(backward_forward(problem, v, eta) - v)


def amtl_max_step(tau: int, num_tasks: int, c: float = 0.9) -> float:
    """Theorem 1 step-size cap: eta_k <= c / (2*tau/sqrt(T) + 1), 0<c<1."""
    if not 0.0 < c < 1.0:
        raise ValueError("c must be in (0,1)")
    return c / (2.0 * tau / (num_tasks ** 0.5) + 1.0)
