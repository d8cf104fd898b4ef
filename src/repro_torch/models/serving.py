"""Prefill and single-token decode for the dense attention families.

Port of the KV-cache part of `repro/models/serving.py`.  The cache mirrors
the scan groups: for each group, a KVCache per period position whose k and
v are stacked over the group's repeat count,

    attn / global : KVCache (n, B, S_max, Hkv, hd)
    local         : KVCache ring (n, B, min(window, S_max), Hkv, hd)

and layer l of a group reads and writes the views [l].  `pos` is a host
int: batched serving with aligned positions, as in the reference.  Decode
writes the new slot of every layer's cache in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import apply_ffn, apply_norm
from repro_torch.models.transformer import (_window, embed_tokens, layer,
                                            lm_logits, require_dense,
                                            scan_groups)

Tensor = torch.Tensor


def _cache_len(kind: BlockKind, cfg: ArchConfig, s_max: int) -> int:
    if kind == "local" and cfg.sliding_window:
        return min(cfg.sliding_window, s_max)
    return s_max


def init_cache(cfg: ArchConfig, batch: int, s_max: int,
               dtype: torch.dtype | None = None, *,
               device: torch.device | str) -> dict:
    """Zero-initialized cache tree."""
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    cache: dict = {}
    for gi, group in enumerate(scan_groups(cfg)):
        cache[f"group{gi}"] = {
            f"b{i}": _init_block_cache(kind, cfg, batch, s_max, group.n,
                                       dtype, device)
            for i, kind in enumerate(group.period)}
    return cache


def _init_block_cache(kind: BlockKind, cfg: ArchConfig, b: int, s_max: int,
                      n: int, dtype: torch.dtype, device) -> KVCache:
    shape = (n, b, _cache_len(kind, cfg, s_max), cfg.num_kv_heads,
             cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _prefill_block(kind: BlockKind, p: dict, x: Tensor, cfg: ArchConfig,
                   s_max: int) -> tuple[Tensor, KVCache]:
    """The block's full-sequence forward and its fitted cache."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    out, cache = attn_lib.attn_forward(
        p["attn"], h, cfg, window=_window(cfg, kind), return_cache=True,
        cache_len=_cache_len(kind, cfg, s_max))
    x = x + out
    h = apply_norm(cfg.norm, p["norm2"], x)
    return x + apply_ffn(p["ffn"], h, cfg.activation), cache


def prefill(params: dict, tokens: Tensor, cfg: ArchConfig,
            s_max: Optional[int] = None) -> tuple[Tensor, dict]:
    """Run the prompt tokens (B, S); returns (last-position logits
    (B, 1, V) float32, cache)."""
    require_dense(cfg)
    b, s = tokens.shape
    s_max = s if s_max is None else s_max
    x = embed_tokens(params, tokens, cfg)
    cache = init_cache(cfg, b, s_max, x.dtype, device=x.device)
    for gi, group in enumerate(scan_groups(cfg)):
        stacked = params[f"group{gi}"]
        for li in range(group.n):
            lp = layer(stacked, li)
            for i, kind in enumerate(group.period):
                x, c = _prefill_block(kind, lp[f"b{i}"], x, cfg, s_max)
                slot = cache[f"group{gi}"][f"b{i}"]
                slot.k[li].copy_(c.k)
                slot.v[li].copy_(c.v)
    return lm_logits(params, x[:, -1:], cfg), cache


def _decode_block(kind: BlockKind, p: dict, x: Tensor, cache: KVCache,
                  pos: int, cfg: ArchConfig) -> Tensor:
    h = apply_norm(cfg.norm, p["norm1"], x)
    out, _ = attn_lib.attn_decode(p["attn"], h, cache, pos, cfg,
                                  window=_window(cfg, kind))
    x = x + out
    h = apply_norm(cfg.norm, p["norm2"], x)
    return x + apply_ffn(p["ffn"], h, cfg.activation)


def decode_step(params: dict, cache: dict, token: Tensor, pos: int,
                cfg: ArchConfig) -> tuple[Tensor, dict]:
    """One decode step.  token: (B, 1) integer; pos: host int.  Returns
    (logits (B, 1, V) float32, cache), the cache updated in place."""
    require_dense(cfg)
    x = embed_tokens(params, token, cfg)
    for gi, group in enumerate(scan_groups(cfg)):
        stacked = params[f"group{gi}"]
        gcache = cache[f"group{gi}"]
        for li in range(group.n):
            lp = layer(stacked, li)
            for i, kind in enumerate(group.period):
                c = gcache[f"b{i}"]
                x = _decode_block(kind, lp[f"b{i}"], x,
                                  KVCache(c.k[li], c.v[li]), int(pos), cfg)
    return lm_logits(params, x, cfg), cache
