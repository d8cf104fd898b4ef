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
"group0.b0.x_prev_att" and "group0.b0.wkv", for an SSM cache
"group0.b0.conv" and "group0.b0.ssm", for a cross layer
"group0.b4.self.k" and "group0.b4.cross.k", for an MLA cache
"group0.b0.c_kv" and "group0.b0.k_rope"; a MoE layer's
"group1.b0.moe.router", an MTP model's "mtp.block.attn.wq_a"), which are
the port's state_dict keys and cache paths too:

    lm_params_from_numpy(cfg, flat, device) -> models.LM
    kv_cache_to_numpy(cache) -> flat    # KVCache (an int8 one with its
                                        # k_scale, v_scale), RWKVState,
                                        # SSMState, CrossKV, MLACache
    kv_cache_from_numpy(cfg, flat, device) -> cache

A bfloat16 array may come with ml_dtypes' `bfloat16` dtype (what
`np.asarray` of a JAX bfloat16 array gives) or as its raw uint16 bits;
either way its bits are carried unchanged.

A training state crosses as the flat dict of the reference's `TrainState`
leaves keyed by '.'-joined path ("params.embed", "opt_state.master.embed",
"opt_state.mu...", "opt_state.nu..." for AdamW, "opt_state.embed.vr" for
Adafactor, "mtl.ring", "mtl.ptr", "mtl.step", "mtl.delay_buf",
"mtl.delay_cnt", "step"), so both packages compute the same steps:

    train_state_from_numpy(cfg, flat, optimizer, device) -> TrainState
    train_state_to_numpy(state) -> flat   # floats as float32

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
from repro_torch.core.mtl_head import MTLHeadState
from repro_torch.device import resolve_device
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.rwkv import RWKVState
from repro_torch.models.serving import CrossKV
from repro_torch.models.ssm import SSMState
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
    path (the top-level "shared_attn.*" of a Zamba2 model among them);
    each leaf takes the reference's dtype for it (`param_dtypes`:
    cfg.dtype, but float32 for the rwkv w0 and u, the mamba A_log, D and
    dt_bias, and the MoE router) on `device` (the card unless the caller
    passes "cpu").  The keys must be exactly the port's."""
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


# a cache node by its fields; a cross layer's {k, v} under "cross" is a
# CrossKV, elsewhere a KVCache (with its scales, an int8 one)
_CACHES = {frozenset(t._fields): t
           for t in (KVCache, RWKVState, SSMState, MLACache)}
_CACHES[frozenset(("k", "v"))] = KVCache
_FLOAT32_CACHE_LEAVES = ("wkv", "ssm", "k_scale", "v_scale")


def kv_cache_to_numpy(cache: dict) -> dict:
    """The cache's leaves (KVCache and CrossKV k, v, and an int8 KVCache's
    k_scale, v_scale; RWKVState x_prev_att, x_prev_ffn, wkv; SSMState conv,
    ssm; MLACache c_kv, k_rope) as float32 host arrays (an exact upcast of
    bfloat16 and int8), keyed by path ("group0.b0.k", "group0.b0.k_scale",
    "group0.b0.wkv", "group0.b0.ssm", "group0.b4.cross.k", ...)."""
    flat = {}
    for path, c in _flatten(cache).items():
        for field, leaf in c._asdict().items():
            if leaf is not None:      # a copy: decode writes the cache
                flat[f"{path}.{field}"] = leaf.detach().to(
                    "cpu", torch.float32, copy=True).numpy()
    return flat


def kv_cache_from_numpy(cfg: ArchConfig, flat: dict,
                        device: torch.device | str | None = None) -> dict:
    """A cache from leaves keyed as `kv_cache_to_numpy` gives them, or as
    the reference's KVCache, RWKVState, SSMState, CrossKV and MLACache
    paths, on `device`: cast to cfg.dtype, except the WKV and SSM states
    and an int8 KVCache's scales, which are float32, and its k and v,
    which are int8."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def build(node: dict, name: str = ""):
        cls = _CACHES.get(frozenset(node))
        if cls is None:
            return {k: build(v, k) for k, v in node.items()}
        quant = "k_scale" in node
        return (CrossKV if name == "cross" else cls)(**{
            k: _tensor(a, torch.float32 if k in _FLOAT32_CACHE_LEAVES else
                       torch.int8 if quant else dtype, dev)
            for k, a in node.items()})

    return build(_nest(flat))


def train_state_from_numpy(cfg: ArchConfig, flat: dict, optimizer,
                           device: torch.device | str | None = None):
    """The port's `launch.steps.TrainState` from the reference's leaves
    (keys as in the module doc): the params (trainable) in their dtypes,
    the optimizer's state in float32 in `optimizer.init`'s layout, the
    head's ring on `device` and its host counters."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.optimizers import tree_items
    dev = resolve_device(device)
    params = {k[len("params."):]: a for k, a in flat.items()
              if k.startswith("params.")}
    model = lm_params_from_numpy(cfg, params, dev)
    model.requires_grad_(True)
    opt_state = optimizer.init(model.tree())
    with torch.no_grad():
        for path, leaf in tree_items(opt_state):
            key = "opt_state." + ".".join(path)
            if key not in flat:
                raise ValueError(f"no leaf {key!r} for the {optimizer.name} "
                                 "state")
            leaf.copy_(_tensor(flat[key], torch.float32, dev))
    mtl = MTLHeadState(
        ring=_tensor(flat["mtl.ring"], torch.float32, dev),
        ptr=int(flat["mtl.ptr"]), step=int(flat["mtl.step"]),
        delay_buf=np.array(flat["mtl.delay_buf"], np.float32),
        delay_cnt=np.array(flat["mtl.delay_cnt"], np.int32))
    return TrainState(model, opt_state, mtl, int(flat["step"]))


def train_state_to_numpy(state) -> dict:
    """The leaves of the reference's `TrainState` equal to `state`, keyed
    as in the module doc; params and optimizer state as float32 (an exact
    upcast of bfloat16), the counters as int32."""
    from repro_torch.optim.optimizers import tree_items

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    out = {"params." + ".".join(path): host(leaf)
           for path, leaf in tree_items(state.params.tree())}
    out.update({"opt_state." + ".".join(path): host(leaf)
                for path, leaf in tree_items(state.opt_state)})
    m = state.mtl
    out.update({"mtl.ring": host(m.ring),
                "mtl.ptr": np.asarray(m.ptr, np.int32),
                "mtl.step": np.asarray(m.step, np.int32),
                "mtl.delay_buf": np.array(m.delay_buf, np.float32),
                "mtl.delay_cnt": np.array(m.delay_cnt, np.int32),
                "step": np.asarray(state.step, np.int32)})
    return out
