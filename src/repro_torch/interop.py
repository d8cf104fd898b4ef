"""Weights and engine state carried between the reference and the port.

Everything crosses as numpy arrays, so the port never sees a JAX array:

    problem_from_numpy(xs, ys, loss_name, reg_name, lam, device,
                       row_counts=None)
    state_from_numpy(kind, leaves, device)     # kind: "delta" or "batch"
    state_to_numpy(state) -> leaves

A TaskStore crosses as its `TaskStoreState` leaves (xs, ys, row_counts),
host numpy on both sides: `store.state()` gives them, and
`TaskStore(*leaves, loss_name, reg_name, lam)` takes them, in either
package.

`leaves` is the flat list of a reference `DeltaAMTLState`/`BatchAMTLState`
in its pytree order (`jax.tree_util.tree_leaves`):

    v, delta_ring, task_ring, ptr, event, p_cache, history.buf,
    history.count, key

with the reference's dtypes (float32 tensors, int32 counters, a raw
uint32[2] key), so `tree_unflatten` of `state_to_numpy(s)` on the
reference's treedef gives a state the reference engine can run on.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.amtl import (BatchAMTLState, DeltaAMTLState,
                                   resolve_device)
from repro_torch.core.dynamic_step import DelayHistory
from repro_torch.core.losses import MTLProblem

LEAVES = ("v", "delta_ring", "task_ring", "ptr", "event", "p_cache",
          "history.buf", "history.count", "key")

_STATES = {"delta": DeltaAMTLState, "batch": BatchAMTLState}


def problem_from_numpy(xs, ys, loss_name: str, reg_name: str, lam: float,
                       device: torch.device | str | None = None,
                       row_counts=None) -> MTLProblem:
    """A stacked problem from (T, n, d) and (T, n) arrays, as float32 on
    `device` (CUDA unless the caller passes "cpu"); `row_counts` (T,)
    makes it ragged, as int32 on the same device."""
    dev = resolve_device(device)
    return MTLProblem(
        torch.as_tensor(np.array(xs, np.float32), device=dev),
        torch.as_tensor(np.array(ys, np.float32), device=dev),
        loss_name, reg_name, float(lam),
        None if row_counts is None else torch.as_tensor(
            np.array(row_counts, np.int32), device=dev))


def state_from_numpy(kind: str, leaves, device: torch.device | str | None = None):
    """The port's engine state from the leaves of a reference state."""
    if kind not in _STATES:
        raise ValueError(f"kind must be one of {sorted(_STATES)}, got {kind!r}")
    if len(leaves) != len(LEAVES):
        raise ValueError(f"expected {len(LEAVES)} leaves {LEAVES}, got "
                         f"{len(leaves)}")
    dev = resolve_device(device)
    v, ring, task_ring, ptr, event, p_cache, buf, count, key = \
        (np.asarray(a) for a in leaves)

    def tensor(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    return _STATES[kind](
        v=tensor(v), delta_ring=tensor(ring),
        task_ring=np.array(task_ring, np.int32), ptr=int(ptr),
        event=int(event), p_cache=tensor(p_cache),
        history=DelayHistory(np.array(buf, np.float32),
                             np.array(count, np.int32)),
        key=np.array(key, np.uint32))


def state_to_numpy(state) -> list[np.ndarray]:
    """The leaves of the reference state equal to `state`."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().astype(np.float32)

    return [host(state.v), host(state.delta_ring),
            np.array(state.task_ring, np.int32),
            np.asarray(state.ptr, np.int32), np.asarray(state.event, np.int32),
            host(state.p_cache), np.array(state.history.buf, np.float32),
            np.array(state.history.count, np.int32),
            np.array(state.key, np.uint32)]
