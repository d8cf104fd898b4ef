"""Weights and engine state carried between the reference and the port.

Everything crosses as numpy arrays, so the port never sees a JAX array:

    problem_from_numpy(xs, ys, loss_name, reg_name, lam, device,
                       row_counts=None)
    state_from_numpy(kind, leaves, device)  # "dense", "delta", "batch",
                                            # "sharded"
    state_to_numpy(state) -> leaves

An LM's parameters and serving cache cross as flat dicts keyed by the
'.'-joined pytree path of the reference's tree (for example
"group0.b1.attn.wq", "group0.b0.k" or, for an RWKV cache,
"group0.b0.x_prev_att" and "group0.b0.wkv"), which are the port's
state_dict keys and cache paths too:

    lm_params_from_numpy(cfg, flat, device) -> models.LM
    kv_cache_to_numpy(cache) -> flat           # KVCache and RWKVState
    kv_cache_from_numpy(cfg, flat, device) -> cache

A bfloat16 array may come with ml_dtypes' `bfloat16` dtype (what
`np.asarray` of a JAX bfloat16 array gives) or as its raw uint16 bits;
either way its bits are carried unchanged.

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
reference's treedef gives a state the reference engine can run on.  A
dense-engine `AMTLState` crosses the same way, as its `DENSE_LEAVES`:

    ring, ptr, event, history.buf, history.count, key

A `ShardedAMTLState` crosses as the reference's global view, in the
`LEAVES` order: v (d, T), delta_ring (n_shards, tau+1, d), p_cache (d, T)
or the stub.  With a mesh of n > 1 ranks (`launch.mesh.TaskMesh`) and
the engine's config, `state_to_numpy(s, mesh=, cfg=)` gathers the ranks'
states (a collective every rank calls), and `state_from_numpy("sharded",
leaves, mesh=, cfg=)` gives each rank its own view; without a mesh the
state is the one rank's, which is the global view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.amtl import (AMTLState, BatchAMTLState,
                                   DeltaAMTLState, ShardedAMTLState,
                                   gather_state, local_state)
from repro_torch.configs.base import ArchConfig
from repro_torch.core.dynamic_step import DelayHistory
from repro_torch.core.losses import MTLProblem
from repro_torch.device import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.rwkv import RWKVState
from repro_torch.models.transformer import LM, param_dtypes, param_shapes

LEAVES = ("v", "delta_ring", "task_ring", "ptr", "event", "p_cache",
          "history.buf", "history.count", "key")

DENSE_LEAVES = ("ring", "ptr", "event", "history.buf", "history.count",
                "key")

_STATES = {"dense": AMTLState, "delta": DeltaAMTLState,
           "batch": BatchAMTLState, "sharded": ShardedAMTLState}


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


def state_from_numpy(kind: str, leaves,
                     device: torch.device | str | None = None, *,
                     mesh=None, cfg=None):
    """The port's engine state from the leaves of a reference state (for
    "sharded" on a mesh of n > 1 ranks: the rank's own view, on the
    mesh's device; `cfg` places the prox cache)."""
    if kind not in _STATES:
        raise ValueError(f"kind must be one of {sorted(_STATES)}, got {kind!r}")
    names = DENSE_LEAVES if kind == "dense" else LEAVES
    if len(leaves) != len(names):
        raise ValueError(f"expected {len(names)} leaves {names}, got "
                         f"{len(leaves)}")
    dev = resolve_device(device) if mesh is None else mesh.device

    def tensor(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    if kind == "dense":
        ring, ptr, event, buf, count, key = (np.asarray(a) for a in leaves)
        return AMTLState(
            ring=tensor(ring), ptr=int(ptr), event=int(event),
            history=DelayHistory(np.array(buf, np.float32),
                                 np.array(count, np.int32)),
            key=np.array(key, np.uint32))
    v, ring, task_ring, ptr, event, p_cache, buf, count, key = \
        (np.asarray(a) for a in leaves)
    state = _STATES[kind](
        v=tensor(v), delta_ring=tensor(ring),
        task_ring=np.array(task_ring, np.int32), ptr=int(ptr),
        event=int(event), p_cache=tensor(p_cache),
        history=DelayHistory(np.array(buf, np.float32),
                             np.array(count, np.int32)),
        key=np.array(key, np.uint32))
    if kind == "sharded" and mesh is not None and mesh.size > 1:
        state = local_state(state, cfg, mesh)
    return state


def state_to_numpy(state, *, mesh=None, cfg=None) -> list[np.ndarray]:
    """The leaves of the reference state equal to `state` (a sharded
    state's global view, gathered over `mesh` when it has n > 1 ranks)."""
    if isinstance(state, ShardedAMTLState):
        state = gather_state(state, cfg, mesh)
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().astype(np.float32)

    tail = [np.array(state.history.buf, np.float32),
            np.array(state.history.count, np.int32),
            np.array(state.key, np.uint32)]
    if isinstance(state, AMTLState):
        return [host(state.ring), np.asarray(state.ptr, np.int32),
                np.asarray(state.event, np.int32), *tail]
    return [host(state.v), host(state.delta_ring),
            np.array(state.task_ring, np.int32),
            np.asarray(state.ptr, np.int32), np.asarray(state.event, np.int32),
            host(state.p_cache), *tail]


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host array as `dtype` on `device`; bfloat16 bits pass unchanged."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (dtype == torch.bfloat16
                                      and a.dtype == np.uint16):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def lm_params_from_numpy(cfg: ArchConfig, flat: dict,
                         device: torch.device | str | None = None) -> LM:
    """The port's model from the reference's parameter leaves, keyed by
    path; each leaf takes the reference's dtype for it (`param_dtypes`:
    cfg.dtype, but float32 for the rwkv w0 and u) on `device` (the card
    unless the caller passes "cpu").  The keys must be exactly the
    port's."""
    dev = resolve_device(device)
    dtypes = param_dtypes(cfg)
    want = param_shapes(cfg)
    got = {k: tuple(np.shape(a)) for k, a in flat.items()}
    if got != want:
        raise ValueError(f"parameter paths or shapes differ: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}, shapes "
                         f"{ {k: (got[k], want[k]) for k in got if k in want and got[k] != want[k]} }")
    return LM(cfg, _nest({k: _tensor(a, dtypes[k], dev)
                          for k, a in flat.items()}))


_CACHES = {frozenset(t._fields): t for t in (KVCache, RWKVState)}


def kv_cache_to_numpy(cache: dict) -> dict:
    """The cache's leaves (KVCache k, v; RWKVState x_prev_att, x_prev_ffn,
    wkv) as float32 host arrays (an exact upcast of bfloat16), keyed by
    path ("group0.b0.k", "group0.b0.wkv", ...)."""
    flat = {}
    for path, c in _flatten(cache).items():
        for field, leaf in c._asdict().items():
            flat[f"{path}.{field}"] = leaf.float().cpu().numpy()
    return flat


def kv_cache_from_numpy(cfg: ArchConfig, flat: dict,
                        device: torch.device | str | None = None) -> dict:
    """A cache from leaves keyed as `kv_cache_to_numpy` gives them, or as
    the reference's KVCache and RWKVState paths, on `device`: cast to
    cfg.dtype, except the WKV state, which stays float32."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    tree = _nest({k: _tensor(a, torch.float32 if k.endswith(".wkv")
                             else dtype, dev) for k, a in flat.items()})

    def build(node: dict):
        cls = _CACHES.get(frozenset(node))
        if cls is not None:
            return cls(**node)
        return {k: build(v) for k, v in node.items()}

    return build(tree)
