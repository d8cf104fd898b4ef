"""Prefill and single-token decode for the attention, MoE, RWKV, Mamba-2
hybrid and vision-language families, and the audio encoder's forward.

Port of `repro/models/serving.py` on one device (the sharded decodes are
ROADMAP item 11(i)).  The cache mirrors the scan groups: for each group, a
cache per period position whose leaves are stacked over the group's
repeat count,

    attn / global / moe : KVCache (n, B, S_max, Hkv, hd); with
                    cfg.kv_cache_dtype "int8" (the self-attention caches
                    of every kind below too) int8 k and v and float32
                    k_scale, v_scale (n, B, S_max, Hkv)
    any attention block of an MLA config (deepseek-v3-671b)
                  : MLACache c_kv (n, B, S_max, kv_lora) and k_rope
                    (n, B, S_max, rope_dim) -- the compressed latent and
                    the shared rope key, which the absorbed decode reads
    local         : KVCache ring (n, B, min(window, S_max), Hkv, hd)
    shared_attn   : KVCache (n, B, S_max, Hkv, hd), one per invocation
    cross         : {"self": KVCache, "cross": CrossKV (n, B, Sv, Hkv, hd)}
                    -- the vision embeddings' keys and values, made once at
                    prefill and read by every decode step
    rwkv          : RWKVState x_prev_att, x_prev_ffn (n, B, D) and wkv
                    (n, B, H, hs, hs) float32 -- O(1) in S_max
    mamba         : SSMState conv (n, B, conv_width - 1, conv_dim) and ssm
                    (n, B, H, P, N) float32 -- O(1) in S_max

and layer l of a group reads and writes the views [l].  A MoE block runs
the routed MoE FFN (`moe.moe_apply`) in prefill and decode; its aux loss
is not read, and neither are an MTP model's `mtp` leaves.  `pos` is a host
int: batched serving with aligned positions, as in the reference.  Prefill
and decode write every layer's cache in place (the new KV slot; the RWKV
shift vectors and the SSM state; the WKV state, which the rwkv6_scan
kernel overwrites itself).

The audio family (hubert-xlarge) is encoder-only: `prefill` takes its
frame features and returns what the reference's does (the last position's
logits and the cache), and `encode` returns every position's logits, what
a user of an encoder reads.  It has no decode.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.rwkv import RWKVState
from repro_torch.models.layers import apply_ffn, apply_norm
from repro_torch.models.ssm import SSMState
from repro_torch.models.transformer import (Extras, _window, attn_flavor,
                                            backbone_forward, embed_inputs,
                                            embed_tokens, lm_logits,
                                            require_ported, require_vision,
                                            scan_groups, shared_attn_params,
                                            unstack)

Tensor = torch.Tensor


class CrossKV(NamedTuple):
    """A cross layer's keys and values of the vision embeddings:
    (B, Sv, Hkv, hd) each."""
    k: Tensor
    v: Tensor


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
    def zeros(*shape, dt=dtype):
        return torch.zeros((n, b) + shape, dtype=dt, device=device)

    if kind == "rwkv":
        hs = cfg.rwkv.head_size
        return RWKVState(x_prev_att=zeros(cfg.d_model),
                         x_prev_ffn=zeros(cfg.d_model),
                         wkv=zeros(cfg.d_model // hs, hs, hs,
                                   dt=torch.float32))
    if kind == "mamba":
        s = cfg.ssm
        _, n_heads, conv_dim = ssm_lib._dims(cfg)
        return SSMState(conv=zeros(s.conv_width - 1, conv_dim),
                        ssm=zeros(n_heads, s.head_dim, s.state_dim,
                                  dt=torch.float32))
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cl = _cache_len(kind, cfg, s_max)
    if cfg.mla is not None:
        kv = MLACache(c_kv=zeros(cl, cfg.mla.kv_lora_rank),
                      k_rope=zeros(cl, cfg.mla.qk_rope_head_dim))
    elif cfg.kv_cache_dtype == "int8":
        kv = KVCache(k=zeros(cl, hkv, hd, dt=torch.int8),
                     v=zeros(cl, hkv, hd, dt=torch.int8),
                     k_scale=zeros(cl, hkv, dt=torch.float32),
                     v_scale=zeros(cl, hkv, dt=torch.float32))
    else:
        kv = KVCache(k=zeros(cl, hkv, hd), v=zeros(cl, hkv, hd))
    if kind == "cross":
        return {"self": kv, "cross": CrossKV(k=zeros(cfg.vision_seq, hkv, hd),
                                             v=zeros(cfg.vision_seq, hkv, hd))}
    return kv


def _layer_cache(c, li: int):
    """Layer li's views of a stacked block cache (a None leaf stays
    None)."""
    if isinstance(c, dict):
        return {k: _layer_cache(v, li) for k, v in c.items()}
    return type(c)(*(None if leaf is None else leaf[li] for leaf in c))


def _write(dst, src) -> None:
    """Copy the leaves of cache `src` into the views `dst`, skipping the
    None ones."""
    for d, s in zip(dst, src, strict=True):
        if d is not None:
            d.copy_(s)


def _cross_kv(p: dict, kv_src: Tensor, cfg: ArchConfig,
              dtype: torch.dtype) -> CrossKV:
    return CrossKV(*attn_lib.cross_kv(p, kv_src, cfg, dtype))


def _cross_decode(p: dict, x: Tensor, xkv: CrossKV,
                  cfg: ArchConfig) -> Tensor:
    """The gated cross-attention of one query row over the Sv cached keys,
    non-causal."""
    return attn_lib.cross_attn(p, x, xkv.k, xkv.v, cfg)


def _ffn(kind: BlockKind, p: dict, h: Tensor, cfg: ArchConfig) -> Tensor:
    """A block's FFN: the MoE FFN on a moe block (its aux loss dropped),
    else the dense one."""
    if kind == "moe":
        return moe_lib.moe_apply(p["moe"], h, cfg)[0]
    return apply_ffn(p["ffn"], h, cfg.activation)


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
                   s_max: int, cache, extras: Extras) -> Tensor:
    """The block's full-sequence forward; writes its cache into `cache`
    (the layer's views of the stacked cache)."""
    if kind == "rwkv":
        return _rwkv_block(p, x, cfg, cache, decode=False)
    h = apply_norm(cfg.norm, p["norm1"], x)
    if kind == "mamba":
        out, state = ssm_lib.mamba_forward(p["mamba"], h, cfg,
                                           return_state=True)
        _write(cache, state)
        return x + out
    cl = _cache_len(kind, cfg, s_max)
    if kind == "shared_attn":
        out, kv = attn_lib.attn_forward(
            shared_attn_params(p, extras.shared_attn), h, cfg,
            return_cache=True, cache_len=cl)
        _write(cache, kv)
        x = x + out
        h = apply_norm(cfg.norm, p["norm2"], x)
        return x + apply_ffn(extras.shared_attn["ffn"], h, cfg.activation)
    out, kv = attn_flavor(p["attn"], h, cfg, kind, return_cache=True,
                          cache_len=cl)
    _write(cache["self"] if kind == "cross" else cache, kv)
    x = x + out
    if kind == "cross":
        h = apply_norm(cfg.norm, p["norm_x"], x)
        xkv = _cross_kv(p["xattn"], require_vision(extras, cfg), cfg, x.dtype)
        _write(cache["cross"], xkv)
        x = x + attn_lib.cross_attn(p["xattn"], h, xkv.k, xkv.v, cfg)
    h = apply_norm(cfg.norm, p["norm2"], x)
    return x + _ffn(kind, p, h, cfg)


def prefill(params: dict, inputs: Tensor, cfg: ArchConfig,
            s_max: Optional[int] = None,
            vision_embeds: Optional[Tensor] = None,
            mask: Optional[Tensor] = None) -> tuple[Tensor, dict]:
    """Run the prompt tokens (B, S), with the vision embeddings
    (B, vision_seq, D) for a vlm; for the audio family `inputs` are frame
    features (B, S, feature_dim) and `mask` the bool (B, S) masked-frame
    input (None: no frame masked).  Returns (last-position logits
    (B, 1, V) float32, cache)."""
    require_ported(cfg)
    b, s = inputs.shape[:2]
    s_max = s if s_max is None else s_max
    if vision_embeds is not None and tuple(vision_embeds.shape) != (
            b, cfg.vision_seq, cfg.d_model):
        raise ValueError(f"{cfg.name}: vision embeddings of shape "
                         f"{tuple(vision_embeds.shape)}, want "
                         f"{(b, cfg.vision_seq, cfg.d_model)}")
    extras = Extras(vision_embeds=vision_embeds,
                    shared_attn=params.get("shared_attn"))
    x = embed_inputs(params, inputs, cfg, mask)
    cache = init_cache(cfg, b, s_max, x.dtype, device=x.device)
    for gi, group in enumerate(scan_groups(cfg)):
        gcache = cache[f"group{gi}"]
        for li, lp in enumerate(unstack(params[f"group{gi}"], group.n)):
            for i, kind in enumerate(group.period):
                x = _prefill_block(kind, lp[f"b{i}"], x, cfg, s_max,
                                   _layer_cache(gcache[f"b{i}"], li), extras)
    return lm_logits(params, x[:, -1:], cfg), cache


def encode(params: dict, features: Tensor, cfg: ArchConfig,
           mask: Optional[Tensor] = None) -> Tensor:
    """The audio encoder's forward: frame features (B, S, feature_dim),
    with the bool `mask` (B, S) (None: no frame masked), to every
    position's logits (B, S, V) float32.  No cache is kept."""
    require_ported(cfg)
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name}: encode is the audio encoder's entry "
                         "point; a decoder runs prefill and decode_step")
    h, _ = backbone_forward(params, embed_inputs(params, features, cfg,
                                                 mask), cfg)
    return lm_logits(params, h, cfg)


def _decode_block(kind: BlockKind, p: dict, x: Tensor, cache, pos: int,
                  cfg: ArchConfig, extras: Extras) -> Tensor:
    if kind == "rwkv":
        return _rwkv_block(p, x, cfg, cache, decode=True)
    h = apply_norm(cfg.norm, p["norm1"], x)
    if kind == "mamba":
        out, state = ssm_lib.mamba_decode(p["mamba"], h, cache, cfg)
        _write(cache, state)
        return x + out
    if kind == "shared_attn":
        out, _ = attn_lib.attn_decode(
            shared_attn_params(p, extras.shared_attn), h, cache, pos, cfg)
        x = x + out
        h = apply_norm(cfg.norm, p["norm2"], x)
        return x + apply_ffn(extras.shared_attn["ffn"], h, cfg.activation)
    self_cache = cache["self"] if kind == "cross" else cache
    if cfg.mla is not None:
        out, _ = attn_lib.mla_decode(p["attn"], h, self_cache, pos, cfg)
    else:
        out, _ = attn_lib.attn_decode(p["attn"], h, self_cache, pos, cfg,
                                      window=_window(cfg, kind))
    x = x + out
    if kind == "cross":
        h = apply_norm(cfg.norm, p["norm_x"], x)
        x = x + _cross_decode(p["xattn"], h, cache["cross"], cfg)
    h = apply_norm(cfg.norm, p["norm2"], x)
    return x + _ffn(kind, p, h, cfg)


def decode_step(params: dict, cache: dict, token: Tensor, pos: int,
                cfg: ArchConfig) -> tuple[Tensor, dict]:
    """One decode step.  token: (B, 1) integer; pos: host int.  Returns
    (logits (B, 1, V) float32, cache), the cache updated in place."""
    require_ported(cfg)
    extras = Extras(shared_attn=params.get("shared_attn"))
    x = embed_tokens(params, token, cfg)
    for gi, group in enumerate(scan_groups(cfg)):
        gcache = cache[f"group{gi}"]
        for li, lp in enumerate(unstack(params[f"group{gi}"], group.n)):
            for i, kind in enumerate(group.period):
                x = _decode_block(kind, lp[f"b{i}"], x,
                                  _layer_cache(gcache[f"b{i}"], li),
                                  int(pos), cfg, extras)
    return lm_logits(params, x, cfg), cache
