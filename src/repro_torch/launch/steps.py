"""Step builders: train_step / prefill_step / decode_step (port of
`repro/launch/steps.py`), and encode_step for the audio encoder.

train_step = backbone forward + backward + the smooth optimizer's update
+ one AMTL round on the multi-task head (the paper's technique as a
feature of every training step).  The serving steps take the model
(`models.LM`) and run under `torch.inference_mode()`.

Unlike the reference's pure step, the port's train step updates the
params and the optimizer state IN PLACE (at gemma2-2b's full width they
are 36.6 GB, and a second copy does not fit an 80 GB card) and returns the
same objects in the new `TrainState`; the head's state is new each step.
The key chain (`fold_in(PRNGKey(17), step)`, split into the stale read's
key and the activation key) is replayed on the host by `core.prng`, so
the staleness and the mask are the reference's bits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.core.mtl_head import (MTLHeadState, amtl_head_update,
                                       init_mtl_state, probe_loss,
                                       prox_threshold, stale_read)
from repro_torch.core.prox import get_regularizer
from repro_torch.models import serving
from repro_torch.models.transformer import (LM, forward, init_params,
                                            require_ported)
from repro_torch.optim import Optimizer, cosine_warmup, make_optimizer
from repro_torch.optim.optimizers import tree_build, tree_items

TRAIN_KEY_SEED = 17


class TrainState(NamedTuple):
    params: LM              # the model; its parameters are the params
    opt_state: dict
    mtl: MTLHeadState
    step: int


def default_optimizer(cfg: ArchConfig, lr: float = 3e-4,
                      total_steps: int = 10000) -> Optimizer:
    """Adafactor for the 671B MoE (its state must fit a pod), AdamW
    otherwise."""
    sched = cosine_warmup(lr, warmup=min(500, total_steps // 10),
                          total=total_steps)
    if cfg.name.startswith("deepseek"):
        return make_optimizer("adafactor", sched)
    return make_optimizer("adamw", sched)


def init_train_state(cfg: ArchConfig, optimizer: Optimizer, seed: int = 0,
                     device: torch.device | str | None = None,
                     model: Optional[LM] = None) -> TrainState:
    """Random weights from `seed` (or the `model` given) made trainable,
    the optimizer's state, and a zero head, on `device` (the card unless
    the caller passes "cpu")."""
    if model is None:
        model = init_params(cfg, seed=seed, device=device)
    model.requires_grad_(True)
    return TrainState(
        params=model, opt_state=optimizer.init(model.tree()),
        mtl=init_mtl_state(cfg.d_model, cfg.mtl, device=model.device),
        step=0)


def train_keys(step: int):
    """(k_read, k_act) of a train step: split(fold_in(PRNGKey(17), step))."""
    key = prng.fold_in(prng.key_from_seed(TRAIN_KEY_SEED), step)
    return tuple(prng.split(key))


def make_train_step(cfg: ArchConfig, optimizer: Optimizer,
                    remat: bool = True):
    """train_step(state, batch) -> (state, metrics).  `batch` holds
    "tokens" (for the audio family "features" and "mask" in their place),
    "targets", "task_ids" and "mtl_targets" on the model's device, and for
    a vlm "vision_embeds" (B, vision_seq, D), which reach `forward` in the
    model's dtype (a leaf with no gradient).  A leaf
    the loss does not reach (an audio model's `embed`) takes a zero
    gradient, as the reference's `value_and_grad` gives it.  The metrics
    are the reference's ("loss", "lm_loss", "probe_loss", "aux_loss",
    "mtl_active_frac", "mtl_mean_staleness", "mtl_v_norm", and "mtp_loss"
    for an MTP model; tensors or host floats) and the round's draws and
    input: "mtl_nu", "mtl_mask" (host arrays) and "pooled" (B, D)."""
    require_ported(cfg, training=True)
    mtl_cfg = cfg.mtl
    reg = get_regularizer(mtl_cfg.reg_name)

    def train_step(state: TrainState, batch: dict):
        k_read, k_act = train_keys(state.step)
        # the AMTL backward step (stale read + server prox), shared between
        # the probe loss and the head update
        v_hat, nu = stale_read(state.mtl, mtl_cfg, k_read)
        p = reg.prox(v_hat, prox_threshold(mtl_cfg))

        model = state.params
        params = model.tree()
        if "vision_embeds" in batch:
            batch = {**batch, "vision_embeds": batch["vision_embeds"].to(
                getattr(torch, cfg.dtype))}
        task_ids = batch["task_ids"]
        targets = batch["mtl_targets"].float()
        with torch.enable_grad():
            loss, metrics = forward(params, batch, cfg, remat=remat)
            pl = probe_loss(p, metrics["pooled"], task_ids, targets)
            total = loss + mtl_cfg.probe_weight * pl
            total.backward()
        grads = tree_build((path, torch.zeros_like(leaf) if leaf.grad is None
                            else leaf.grad)
                           for path, leaf in tree_items(params))
        optimizer.update(grads, state.opt_state, params, state.step)
        del grads
        for leaf in model.parameters():
            leaf.grad = None
        pooled = metrics["pooled"].detach()
        new_mtl, mtl_metrics = amtl_head_update(
            state.mtl, pooled, task_ids, targets, mtl_cfg, k_act,
            read=(p, nu))
        out = {"loss": total.detach(),
               "lm_loss": metrics["lm_loss"].detach(),
               "probe_loss": pl.detach(),
               "aux_loss": metrics["aux_loss"].detach(), **mtl_metrics,
               "pooled": pooled}
        if "mtp_loss" in metrics:
            out["mtp_loss"] = metrics["mtp_loss"].detach()
        return TrainState(model, state.opt_state, new_mtl,
                          state.step + 1), out

    return train_step


def make_prefill_step(cfg: ArchConfig, s_max: Optional[int] = None):
    """prefill_step(model, inputs, vision_embeds=None, mask=None): token
    ids (B, S), with the vision embeddings (B, vision_seq, D) of a vlm; for
    the audio family the frame features (B, S, feature_dim) and the bool
    mask (B, S) (None: no frame masked)."""
    def prefill_step(model: LM, inputs: torch.Tensor,
                     vision_embeds: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None):
        with torch.inference_mode():
            return serving.prefill(model.tree(), inputs, cfg, s_max=s_max,
                                   vision_embeds=vision_embeds, mask=mask)
    return prefill_step


def make_encode_step(cfg: ArchConfig):
    """encode_step(model, features, mask=None): the audio encoder's
    logits at every position (B, S, V) float32 (`serving.encode`)."""
    def encode_step(model: LM, features: torch.Tensor,
                    mask: Optional[torch.Tensor] = None):
        with torch.inference_mode():
            return serving.encode(model.tree(), features, cfg, mask=mask)
    return encode_step


def make_decode_step(cfg: ArchConfig):
    def decode(model: LM, cache: dict, token: torch.Tensor, pos: int):
        with torch.inference_mode():
            return serving.decode_step(model.tree(), cache, token, pos, cfg)
    return decode
