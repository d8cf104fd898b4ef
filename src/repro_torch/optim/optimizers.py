"""Optimizers with fp32 master weights (port of `repro/optim/optimizers.py`).

Policy as in the reference: the model's params may be bf16 (the compute
copy); the optimizer state holds an fp32 master plus moments, and each
update casts the master back to the params' dtype.

An `Optimizer` is `(name, init, update)`.  `init(params)` takes a nested
dict of tensors and gives the state; `update(grads, state, params, step)`
takes grads of the params' structure and a host int step.  Unlike the
reference, whose arrays are immutable, `update` writes the state and the
params IN PLACE (at full width the state is 31 GB, and a second copy
does not fit the card) and returns the same two objects.

Leaves are visited in the reference's pytree order: each dict's keys
sorted (`tree_items`), which is the order `global_norm` sums them in.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor
_F = np.float32


class Optimizer(NamedTuple):
    name: str
    init: Callable        # params -> opt_state
    update: Callable      # (grads, opt_state, params, step) -> (params, st)


def tree_items(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, Tensor]]:
    """(path, leaf) of a nested dict of tensors, keys sorted at each level
    (JAX's order for dict pytrees)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tree_items(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def tree_build(items) -> dict:
    """A nested dict from (path, value) pairs."""
    out: dict = {}
    for path, v in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _master(p: Tensor) -> Tensor:
    """A float32 copy of p (a real copy even when p is float32)."""
    return p.detach().to(torch.float32, copy=True)


def global_norm(tree: dict) -> Tensor:
    """sqrt of the sum of the leaves' float32 sums of squares, summed in
    the reference's leaf order."""
    total = 0
    for _, leaf in tree_items(tree):
        total = total + torch.sum(leaf.float() ** 2)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


# ----------------------------------------------------------------- AdamW ---

def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        items = tree_items(params)
        return {
            "master": tree_build((k, _master(p)) for k, p in items),
            "mu": tree_build((k, torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device))
                             for k, p in items),
            "nu": tree_build((k, torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device))
                             for k, p in items),
        }

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = float(lr_fn(step))
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        t = _F(step) + _F(1.0)
        bc1 = float(_F(1.0) - _F(b1) ** t)
        bc2 = float(_F(1.0) - _F(b2) ** t)
        for path, g in tree_items(grads):
            m = tree_get(state["master"], path)
            mu = tree_get(state["mu"], path)
            nu = tree_get(state["nu"], path)
            g = g.float() * scale
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).add_(g * g, alpha=1 - b2)
            del g
            upd = (mu / bc1).div_((nu / bc2).sqrt_().add_(eps))
            m.sub_(upd.add_(m, alpha=weight_decay).mul_(lr))
            del upd
            tree_get(params, path).copy_(m)
        return params, state

    return Optimizer("adamw", init, update)


# -------------------------------------------------------------- Adafactor --

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(lr_fn, eps: float = 1e-30, decay: float = 0.8,
              weight_decay: float = 0.0, clip_threshold: float = 1.0
              ) -> Optimizer:
    """Factored second moments for >= 2-D leaves; no first moment.  The
    state holds, at each param's path, a dict {"master", "vr", "vc"} (or
    {"master", "v"} for a leaf that is not factored)."""

    def init(params):
        def st(p):
            entry = {"master": _master(p)}
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                entry["vr"] = torch.zeros(p.shape[:-1], **z)
                entry["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:], **z)
            else:
                entry["v"] = torch.zeros(p.shape, **z)
            return entry
        return tree_build((k, st(p)) for k, p in tree_items(params))

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = float(lr_fn(step))
        t = _F(step) + _F(1.0)
        beta = float(_F(1.0) - t ** _F(-decay))
        for path, g in tree_items(grads):
            st = tree_get(state, path)
            g2 = g.float() ** 2 + eps
            m = st["master"]
            if "vr" in st:
                st["vr"].mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
                st["vc"].mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
                row_mean = torch.clamp(st["vr"].mean(dim=-1, keepdim=True),
                                       min=eps)
                denom = torch.sqrt((st["vr"] / row_mean)[..., None]
                                   * st["vc"][..., None, :])
            else:
                st["v"].mul_(beta).add_((1 - beta) * g2)
                denom = torch.sqrt(st["v"])
            u = g.float() / torch.clamp(denom, min=eps)
            rms_u = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            m.sub_(lr * (u + weight_decay * m))
            tree_get(params, path).copy_(m)
        return params, state

    return Optimizer("adafactor", init, update)


# ------------------------------------------------------------------ SGDM ---

def sgdm(lr_fn, momentum: float = 0.9, weight_decay: float = 0.0
         ) -> Optimizer:
    def init(params):
        items = tree_items(params)
        return {"master": tree_build((k, _master(p)) for k, p in items),
                "mu": tree_build((k, torch.zeros(p.shape,
                                                 dtype=torch.float32,
                                                 device=p.device))
                                 for k, p in items)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = float(lr_fn(step))
        for path, g in tree_items(grads):
            m = tree_get(state["master"], path)
            mu = tree_get(state["mu"], path)
            mu.mul_(momentum).add_(g.float() + weight_decay * m)
            m.sub_(lr * mu)
            tree_get(params, path).copy_(m)
        return params, state

    return Optimizer("sgdm", init, update)


def make_optimizer(name: str, lr_fn, **kwargs) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}[name](
        lr_fn, **kwargs)
