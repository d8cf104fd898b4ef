"""Prefill and single-token decode for the dense attention and RWKV
families.

Port of the attention and RWKV parts of `repro/models/serving.py`.  The
cache mirrors the scan groups: for each group, a cache per period position
whose leaves are stacked over the group's repeat count,

    attn / global : KVCache (n, B, S_max, Hkv, hd)
    local         : KVCache ring (n, B, min(window, S_max), Hkv, hd)
    rwkv          : RWKVState x_prev_att, x_prev_ffn (n, B, D) and wkv
                    (n, B, H, hs, hs) float32 -- O(1) in S_max

and layer l of a group reads and writes the views [l].  `pos` is a host
int: batched serving with aligned positions, as in the reference.  Prefill
and decode write every layer's cache in place (the new KV slot; the RWKV
shift vectors, and the WKV state, which the rwkv6_scan kernel overwrites
itself).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.models import attention as attn_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.rwkv import RWKVState
from repro_torch.models.layers import apply_ffn, apply_norm
from repro_torch.models.transformer import (_window, embed_tokens, layer,
                                            lm_logits, require_ported,
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
                      n: int, dtype: torch.dtype, device):
    if kind == "rwkv":
        hs = cfg.rwkv.head_size
        return RWKVState(
            x_prev_att=torch.zeros((n, b, cfg.d_model), dtype=dtype,
                                   device=device),
            x_prev_ffn=torch.zeros((n, b, cfg.d_model), dtype=dtype,
                                   device=device),
            wkv=torch.zeros((n, b, cfg.d_model // hs, hs, hs),
                            dtype=torch.float32, device=device))
    shape = (n, b, _cache_len(kind, cfg, s_max), cfg.num_kv_heads,
             cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _layer_cache(c, li: int):
    """Layer li's views of a stacked block cache."""
    return type(c)(*(leaf[li] for leaf in c))


def _rwkv_block(p: dict, x: Tensor, cfg: ArchConfig, state: RWKVState,
                decode: bool) -> Tensor:
    """An rwkv block over x from `state` (layer views of the cache, zeros
    before prefill), which it updates in place."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    if decode:
        out, _, x_att = rwkv_lib.rwkv_decode_time_mix(p["rwkv"], h, state,
                                                      cfg)
    else:
        out, _, x_att = rwkv_lib.rwkv_time_mix(p["rwkv"], h, cfg,
                                               state=state, return_state=True)
    x = x + out
    h = apply_norm(cfg.norm, p["norm2"], x)
    out, x_ffn = rwkv_lib.rwkv_channel_mix(p["rwkv"], h,
                                           x_prev=state.x_prev_ffn,
                                           return_state=True)
    state.x_prev_att.copy_(x_att)
    state.x_prev_ffn.copy_(x_ffn)
    return x + out


def _prefill_block(kind: BlockKind, p: dict, x: Tensor, cfg: ArchConfig,
                   s_max: int, slot, li: int) -> Tensor:
    """The block's full-sequence forward; writes its cache into layer li of
    the stacked `slot`."""
    if kind == "rwkv":
        return _rwkv_block(p, x, cfg, _layer_cache(slot, li), decode=False)
    h = apply_norm(cfg.norm, p["norm1"], x)
    out, cache = attn_lib.attn_forward(
        p["attn"], h, cfg, window=_window(cfg, kind), return_cache=True,
        cache_len=_cache_len(kind, cfg, s_max))
    slot.k[li].copy_(cache.k)
    slot.v[li].copy_(cache.v)
    x = x + out
    h = apply_norm(cfg.norm, p["norm2"], x)
    return x + apply_ffn(p["ffn"], h, cfg.activation)


def prefill(params: dict, tokens: Tensor, cfg: ArchConfig,
            s_max: Optional[int] = None) -> tuple[Tensor, dict]:
    """Run the prompt tokens (B, S); returns (last-position logits
    (B, 1, V) float32, cache)."""
    require_ported(cfg)
    b, s = tokens.shape
    s_max = s if s_max is None else s_max
    x = embed_tokens(params, tokens, cfg)
    cache = init_cache(cfg, b, s_max, x.dtype, device=x.device)
    for gi, group in enumerate(scan_groups(cfg)):
        stacked = params[f"group{gi}"]
        for li in range(group.n):
            lp = layer(stacked, li)
            for i, kind in enumerate(group.period):
                x = _prefill_block(kind, lp[f"b{i}"], x, cfg, s_max,
                                   cache[f"group{gi}"][f"b{i}"], li)
    return lm_logits(params, x[:, -1:], cfg), cache


def _decode_block(kind: BlockKind, p: dict, x: Tensor, cache, pos: int,
                  cfg: ArchConfig) -> Tensor:
    if kind == "rwkv":
        return _rwkv_block(p, x, cfg, cache, decode=True)
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
    require_ported(cfg)
    x = embed_tokens(params, token, cfg)
    for gi, group in enumerate(scan_groups(cfg)):
        stacked = params[f"group{gi}"]
        gcache = cache[f"group{gi}"]
        for li in range(group.n):
            lp = layer(stacked, li)
            for i, kind in enumerate(group.period):
                x = _decode_block(kind, lp[f"b{i}"], x,
                                  _layer_cache(gcache[f"b{i}"], li),
                                  int(pos), cfg)
    return lm_logits(params, x, cfg), cache
