"""Mesh-AMTL head: the paper's technique inside every train step (port of
`repro/core/mtl_head.py`).

T task-specific linear probes W = [w_1..w_T] in R^{d_model x T} sit on the
backbone's pooled hidden state and are coupled by a non-smooth regularizer
(nuclear norm by default).  The smooth optimizer never updates them; each
train step performs one AMTL round instead:

  * activation mask  m ~ Bernoulli(rate)^T      (Poisson thinning, Asm. 1)
  * per-task stale read from a ring of the last tau+1 iterates
    (nu_t sampled <= tau)
  * backward step: p = prox_{eta lam g}(v_hat)
  * forward step with the analytic least-squares probe gradient
  * KM write-back with the delay-adaptive step of Eq. III.5/III.6

The probe loss also flows into the backbone, but W itself sees only AMTL
updates.

The state's ring (tau+1, d, T) float32 lives on the model's device; the
pointer, the step count and the delay history depend only on the key
chain, never on the iterate, so they stay on the host (Python ints and
numpy arrays in the reference's layout), as the engines keep theirs.  The
staleness and the mask are drawn on the host by `core.prng`, bit for bit
the reference's `jax.random` draws.  The KM write-back is a (d, T)
elementwise update that the reference computes with jnp outside any
Pallas kernel; it stays plain tensor code here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import MTLCfg
from repro_torch.core import prng
from repro_torch.core.dynamic_step import dynamic_multiplier
from repro_torch.core.operators import amtl_max_step
from repro_torch.core.prox import get_regularizer

Tensor = torch.Tensor


class MTLHeadState(NamedTuple):
    ring: Tensor            # (tau+1, d, T) float32: past iterates of V
    ptr: int                # newest slot
    step: int               # rounds so far
    delay_buf: np.ndarray   # (T, window) float32 recent staleness per task
    delay_cnt: np.ndarray   # (T,) int32


def init_mtl_state(d_model: int, cfg: MTLCfg, window: int = 5,
                   device: torch.device | str = "cpu") -> MTLHeadState:
    t = cfg.num_tasks
    return MTLHeadState(
        ring=torch.zeros((cfg.tau + 1, d_model, t), dtype=torch.float32,
                         device=device),
        ptr=0, step=0,
        delay_buf=np.zeros((t, window), np.float32),
        delay_cnt=np.zeros((t,), np.int32))


def prox_threshold(cfg: MTLCfg) -> float:
    """eta * lam as the reference's float32 scalar."""
    return float(np.float32(cfg.eta * cfg.lam))


def stale_read(state: MTLHeadState, cfg: MTLCfg, key
               ) -> tuple[Tensor, np.ndarray]:
    """Per-task stale read v_hat (d, T) and the sampled staleness (T,).

    Column t comes from iterate (k - nu_t): a stale and inconsistent read
    (different columns from different pasts).  `key` is a raw uint32[2]
    key."""
    depth = cfg.tau + 1
    t = state.ring.shape[-1]
    nu = prng.randint_shaped(key, (t,), 0, cfg.tau + 1)
    nu = np.minimum(nu, np.int32(state.step))           # can't pre-date 0
    idx = torch.as_tensor((state.ptr - nu) % depth, dtype=torch.long,
                          device=state.ring.device)
    cols = torch.arange(t, device=state.ring.device)
    v_hat = state.ring[idx, :, cols].T                   # (d, T)
    return v_hat, nu


def probe_predictions(p_cols: Tensor, pooled: Tensor,
                      task_ids: Tensor) -> Tensor:
    """y_hat_i = pooled_i . p[:, task_i].  pooled: (B, d) float32."""
    w_per_ex = p_cols.T[task_ids.long()]                 # (B, d)
    return torch.sum(pooled * w_per_ex, dim=-1)


def probe_loss(p_cols: Tensor, pooled: Tensor, task_ids: Tensor,
               targets: Tensor) -> Tensor:
    """Least-squares probe loss (the paper's regression tasks)."""
    r = probe_predictions(p_cols, pooled, task_ids) - targets
    return torch.mean(r * r)


def probe_task_grads(p_cols: Tensor, pooled: Tensor, task_ids: Tensor,
                     targets: Tensor) -> Tensor:
    """Analytic d loss_t / d p_t, column-stacked (d, T): the mean over task
    t's examples of 2 pooled_i (pooled_i . p_t - y_i)."""
    t = p_cols.shape[1]
    r = probe_predictions(p_cols, pooled, task_ids) - targets     # (B,)
    onehot = torch.nn.functional.one_hot(task_ids.long(), t).to(pooled.dtype)
    g = 2.0 * torch.einsum("bd,b,bt->dt", pooled, r, onehot)
    counts = torch.clamp(onehot.sum(dim=0), min=1.0)
    return g / counts


def step_sizes(cfg: MTLCfg, num_tasks: int,
               mean_delay: np.ndarray) -> np.ndarray:
    """(T,) float32 delay-adaptive KM steps (Eq. III.5/III.6), capped by
    Theorem 1."""
    base = np.float32(min(cfg.km_relax,
                          amtl_max_step(cfg.tau, num_tasks, 0.99) * 3.0))
    if not cfg.dynamic_step:
        return np.full((num_tasks,), base, np.float32)
    mult = dynamic_multiplier(mean_delay) / dynamic_multiplier(
        np.zeros_like(mean_delay))
    return (base * mult).astype(np.float32)


def amtl_head_update(state: MTLHeadState, pooled: Tensor, task_ids: Tensor,
                     targets: Tensor, cfg: MTLCfg, key,
                     read: tuple[Tensor, np.ndarray] | None = None
                     ) -> tuple[MTLHeadState, dict]:
    """One AMTL round; returns (new state, metrics).  The old state is left
    as it was.

    `read` may carry a precomputed (p, nu) pair, so the train step reuses
    one backward-step output for the probe loss and the head update.  The
    metrics hold the round's draws too: "mtl_nu" (T,) int32 and
    "mtl_mask" (T,) bool, host arrays."""
    reg = get_regularizer(cfg.reg_name)
    k_read, k_act = prng.split(key)
    t = state.ring.shape[-1]
    depth = cfg.tau + 1

    v_cur = state.ring[state.ptr]                        # (d, T)
    if read is None:
        v_hat, nu = stale_read(state, cfg, k_read)
        p = reg.prox(v_hat, prox_threshold(cfg))
    else:
        p, nu = read

    g = probe_task_grads(p, pooled.float(), task_ids, targets.float())

    window = state.delay_buf.shape[1]
    delay_buf = state.delay_buf.copy()
    delay_buf[np.arange(t), state.delay_cnt % window] = nu.astype(np.float32)
    delay_cnt = (state.delay_cnt + 1).astype(np.int32)
    n_recent = np.minimum(delay_cnt, window)
    mean_delay = (delay_buf.sum(axis=1, dtype=np.float32)
                  / np.maximum(n_recent, 1).astype(np.float32))
    eta_k = step_sizes(cfg, t, mean_delay)

    m = prng.bernoulli(k_act, cfg.activation_rate, (t,))
    dev = state.ring.device

    delta = p - cfg.eta * g - v_cur                      # fused Eq. III.4
    v_new = v_cur + torch.where(
        torch.as_tensor(m, device=dev)[None, :],
        torch.as_tensor(eta_k, device=dev)[None, :] * delta, 0.0)

    ptr = (state.ptr + 1) % depth
    ring = state.ring.clone()
    ring[ptr] = v_new
    new_state = MTLHeadState(ring, ptr, state.step + 1, delay_buf, delay_cnt)
    metrics = {
        "mtl_active_frac": np.float32(m.mean(dtype=np.float32)),
        "mtl_mean_staleness": np.float32(nu.astype(np.float32).mean(
            dtype=np.float32)),
        "mtl_v_norm": torch.linalg.vector_norm(v_new),
        "mtl_nu": nu, "mtl_mask": m,
    }
    return new_state, metrics


def head_weights(state: MTLHeadState, cfg: MTLCfg) -> Tensor:
    """W = prox(V): the deployable multi-task head (one extra backward)."""
    reg = get_regularizer(cfg.reg_name)
    return reg.prox(state.ring[state.ptr], prox_threshold(cfg))
