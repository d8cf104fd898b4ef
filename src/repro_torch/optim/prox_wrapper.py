"""Proximal composition: any smooth optimizer + a prox on selected leaves
(port of `repro/optim/prox_wrapper.py`).

After each smooth update, prox_{eta_ref*lam*g} is applied to the leaves
that `select(path)` picks (path: the tuple of the leaf's dict keys), as a
(rows, -1) matrix, in place; where the state carries a top-level
"master" (adamw, sgdm), the selected leaves' masters are set to the
projected params in float32.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.prox import get_regularizer
from repro_torch.optim.optimizers import Optimizer, tree_get, tree_items


def proximal_wrap(opt: Optimizer, reg_name: str, lam: float,
                  select: Callable[[tuple], bool],
                  eta_ref: float = 1.0) -> Optimizer:
    reg = get_regularizer(reg_name)
    t = float(np.float32(eta_ref * lam))

    @torch.no_grad()
    def update(grads, state, params, step):
        params, state = opt.update(grads, state, params, step)
        sync_master = isinstance(state, dict) and "master" in state
        for path, leaf in tree_items(params):
            if not select(tuple(str(k) for k in path)):
                continue
            mat = leaf if leaf.dim() == 2 else leaf.reshape(leaf.shape[0], -1)
            leaf.copy_(reg.prox(mat, t).reshape(leaf.shape))
            if sync_master:
                tree_get(state["master"], path).copy_(leaf)
        return params, state

    return Optimizer(f"prox_{opt.name}", opt.init, update)
