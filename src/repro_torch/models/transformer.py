"""Transformer assembly: scan groups of blocks, embedding and LM head.

Port of `repro/models/transformer.py` for the block kinds attn, local,
global (dense attention) and rwkv.  The model is a `torch.nn.Module` whose
parameter tree mirrors the reference's pytree: a scan group's leaves are
stacked over its repeat count, as `jax.vmap(init_period)` stacks them, so

    embed (V, D), final_norm.scale (D,),
    group{gi}.b{i}.norm1.scale (n, D), group{gi}.b{i}.attn.wq (n, D, H*hd),
    group{gi}.b{i}.ffn.w_in (n, D, F), ...

are both the state_dict keys here and the '.'-joined pytree paths there
(`interop.lm_params_from_numpy` maps one to the other).  Layer l of a group
reads the views leaf[l].  Training (`forward`, `cross_entropy`), MoE, SSM,
shared and cross attention are later slices and raise.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.layers import (apply_ffn, apply_norm, dense_init,
                                       embed_init, init_ffn, init_norm,
                                       is_gated, softcap)

Tensor = torch.Tensor

PORTED_KINDS = ("attn", "local", "global", "rwkv")


class ScanGroup(NamedTuple):
    period: tuple[BlockKind, ...]
    n: int


def scan_groups(cfg: ArchConfig) -> list[ScanGroup]:
    groups: list[ScanGroup] = []
    if cfg.head_blocks:
        blocks = cfg.head_blocks
        if len(set(blocks)) == 1:
            groups.append(ScanGroup((blocks[0],), len(blocks)))
        else:
            groups.append(ScanGroup(tuple(blocks), 1))
    if cfg.num_periods:
        groups.append(ScanGroup(tuple(cfg.period), cfg.num_periods))
    if cfg.tail_blocks:
        if len(set(cfg.tail_blocks)) == 1:
            groups.append(ScanGroup((cfg.tail_blocks[0],),
                                    len(cfg.tail_blocks)))
        else:
            groups.append(ScanGroup(tuple(cfg.tail_blocks), 1))
    return groups


def require_ported(cfg: ArchConfig) -> None:
    """Raise for a config that needs a block kind (other than attn, local,
    global and rwkv) or a feature the port does not have yet."""
    kinds = set(cfg.layer_kinds) - set(PORTED_KINDS)
    if kinds or cfg.moe or cfg.mla or cfg.feature_dim or cfg.mtp \
            or cfg.kv_cache_dtype != "model":
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds)} (or MoE, MLA, audio, "
            "MTP, the int8 KV cache) are not ported yet (ROADMAP.md, "
            "Queue 1 item 11)")


class ParamTree(nn.Module):
    """A nested dict of tensors held as frozen parameters, so that the
    state_dict keys are the '.'-joined paths of the dict."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def tree(self) -> dict:
        out = {name: p for name, p in self._parameters.items()}
        out.update({name: m.tree() for name, m in self._modules.items()})
        return out


def layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked tree: every leaf's view [i]."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _init_block(kind: BlockKind, cfg: ArchConfig, dtype: torch.dtype,
                gen: torch.Generator, n: int) -> dict:
    d, dev, lead = cfg.d_model, gen.device, (n,)
    if kind == "rwkv":
        return {"norm1": init_norm(cfg.norm, d, dtype, dev, lead),
                "norm2": init_norm(cfg.norm, d, dtype, dev, lead),
                "rwkv": rwkv_lib.init_rwkv(cfg, dtype, gen, lead)}
    return {"norm1": init_norm(cfg.norm, d, dtype, dev, lead),
            "attn": attn_lib.init_attn(cfg, dtype, gen, lead),
            "norm2": init_norm(cfg.norm, d, dtype, dev, lead),
            "ffn": init_ffn(d, cfg.d_ff, cfg.activation, dtype, gen, lead)}


class LM(ParamTree):
    """The model's parameters; `cfg` rides along."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def init_params(cfg: ArchConfig, seed: int = 0,
                device: torch.device | str | None = None) -> LM:
    """Random weights from a seeded torch.Generator on `device` (the card
    unless the caller passes "cpu"), with the reference's distributions:
    truncated-normal fan-in matrices, N(0, 1/D) embeddings, unit norms."""
    require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    tree: dict = {"embed": embed_init(cfg.vocab_size, cfg.d_model, dtype,
                                      gen)}
    if not cfg.tie_embeddings:
        tree["unembed"] = dense_init((cfg.d_model, cfg.vocab_size), dtype,
                                     gen)
    tree["final_norm"] = init_norm(cfg.norm, cfg.d_model, dtype, dev)
    for gi, group in enumerate(scan_groups(cfg)):
        tree[f"group{gi}"] = {
            f"b{i}": _init_block(kind, cfg, dtype, gen, group.n)
            for i, kind in enumerate(group.period)}
    return LM(cfg, tree)


def param_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """The path and shape of every parameter `init_params` makes."""
    require_ported(cfg)
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"embed": (cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.vocab_size)
    shapes["final_norm.scale"] = (d,)
    if cfg.norm == "layernorm":
        shapes["final_norm.bias"] = (d,)
    for gi, group in enumerate(scan_groups(cfg)):
        n = group.n
        for i, kind in enumerate(group.period):
            pre = f"group{gi}.b{i}."
            if kind == "rwkv":
                block = {f"rwkv.{k}": v
                         for k, v in rwkv_lib.param_shapes(cfg).items()}
            else:
                block = {"attn.wq": (d, h * hd), "attn.wk": (d, hkv * hd),
                         "attn.wv": (d, hkv * hd), "attn.wo": (h * hd, d),
                         "ffn.w_in": (d, cfg.d_ff),
                         "ffn.w_out": (cfg.d_ff, d)}
                if is_gated(cfg.activation):
                    block["ffn.w_gate"] = (d, cfg.d_ff)
                if cfg.qk_norm:
                    block["attn.q_norm.scale"] = \
                        block["attn.k_norm.scale"] = (hd,)
            for nm in ("norm1", "norm2"):
                block[f"{nm}.scale"] = (d,)
                if cfg.norm == "layernorm":
                    block[f"{nm}.bias"] = (d,)
            shapes.update({pre + k: (n,) + v for k, v in block.items()})
    return shapes


def param_dtypes(cfg: ArchConfig) -> dict[str, torch.dtype]:
    """The dtype of every parameter `init_params` makes: cfg.dtype, except
    the rwkv leaves the reference keeps in float32 (w0, u)."""
    dtype = getattr(torch, cfg.dtype)
    f32 = tuple(f".rwkv.{name}" for name in rwkv_lib.FLOAT32_LEAVES)
    return {path: torch.float32 if path.endswith(f32) else dtype
            for path in param_shapes(cfg)}


def _window(cfg: ArchConfig, kind: BlockKind):
    return cfg.sliding_window if kind == "local" else None


def apply_block(kind: BlockKind, p: dict, x: Tensor,
                cfg: ArchConfig) -> Tensor:
    """One pre-norm block: x + attn(norm1 x), then + ffn(norm2 x); for
    rwkv, the time mix and the channel mix in their places."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    if kind == "rwkv":
        x = x + rwkv_lib.rwkv_time_mix(p["rwkv"], h, cfg)
        h = apply_norm(cfg.norm, p["norm2"], x)
        return x + rwkv_lib.rwkv_channel_mix(p["rwkv"], h)
    x = x + attn_lib.attn_forward(p["attn"], h, cfg,
                                  window=_window(cfg, kind))
    h = apply_norm(cfg.norm, p["norm2"], x)
    return x + apply_ffn(p["ffn"], h, cfg.activation)


def backbone_forward(params: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    """Run all scan groups over x (B, S, D), layer by layer."""
    require_ported(cfg)
    for gi, group in enumerate(scan_groups(cfg)):
        stacked = params[f"group{gi}"]
        for li in range(group.n):
            lp = layer(stacked, li)
            for i, kind in enumerate(group.period):
                x = apply_block(kind, lp[f"b{i}"], x, cfg)
    return x


def embed_tokens(params: dict, tokens: Tensor, cfg: ArchConfig) -> Tensor:
    x = params["embed"][tokens]
    if cfg.tie_embeddings:   # gemma-style scaling, in x's dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def lm_logits(params: dict, h: Tensor, cfg: ArchConfig) -> Tensor:
    """Final norm, the (tied) unembedding, and the logit softcap in
    float32."""
    h = apply_norm(cfg.norm, params["final_norm"], h)
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = h @ params["unembed"].to(h.dtype)
    return softcap(logits.float(), cfg.logit_softcap)
