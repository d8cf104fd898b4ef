"""GQA attention (full, sliding-window, softcap) for prefill and decode, and
gated cross-attention (Llama-3.2-Vision style).

Port of the GQA and cross-attention parts of `repro/models/attention.py`.
Every attention call goes through `ops.mha`: the flash-attention CUDA
kernel for CUDA tensors, the plain chunked online softmax (`ref.mha_ref`)
for CPU tensors.  MLA, the int8 KV cache and the sharded decode are later
slices of the port; `transformer.init_params` and
`interop.lm_params_from_numpy` refuse configs that need them.

One deliberate difference from the reference: the KV cache of a
sliding-window layer is a ring in which position p always sits at slot
p % cache_len, after prefill as during decode.  The reference's
`_fit_cache` stores the last `window` prompt positions at slots
0..window-1, which `attn_decode`'s ring (slot pos % window) agrees with
only when the prompt is no longer than the window or a multiple of it;
elsewhere its decode evicts a key still in the window.  Where the two
layouts agree the port is held to the reference, and everywhere its decode
equals its own full prefill.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_norm, apply_rope, dense_init,
                                       init_norm)

Tensor = torch.Tensor


class KVCache(NamedTuple):
    """Per-layer KV cache.  k/v: (B, S_max, Hkv, hd); a ring of `window`
    slots on sliding-window layers."""
    k: Tensor
    v: Tensor


def mha(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
        window: Optional[int] = None, softcap: Optional[float] = None,
        q_offset: int = 0, kv_valid_len: Optional[int] = None,
        kv_chunk: int = 1024) -> Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd); GQA by head grouping.
    q_offset: absolute position of q[0]; kv_valid_len: valid cache
    entries.  Both are host ints."""
    return ops.mha(q, k, v, causal=causal, window=window, softcap=softcap,
                   q_offset=q_offset, kv_valid_len=kv_valid_len,
                   kv_chunk=kv_chunk)


def init_attn(cfg: ArchConfig, dtype: torch.dtype, gen: torch.Generator,
              lead: tuple[int, ...] = ()) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": dense_init(lead + (d, h * hd), dtype, gen),
         "wk": dense_init(lead + (d, hkv * hd), dtype, gen),
         "wv": dense_init(lead + (d, hkv * hd), dtype, gen),
         "wo": dense_init(lead + (h * hd, d), dtype, gen)}
    if cfg.qk_norm:
        p["q_norm"] = init_norm("rmsnorm", hd, dtype, gen.device, lead)
        p["k_norm"] = init_norm("rmsnorm", hd, dtype, gen.device, lead)
    return p


def _project_qkv(p: dict, x: Tensor, cfg: ArchConfig, positions: Tensor,
                 theta: float):
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, hkv, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = apply_norm("rmsnorm", p["q_norm"], q)
        k = apply_norm("rmsnorm", p["k_norm"], k)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def attn_forward(p: dict, x: Tensor, cfg: ArchConfig, *,
                 window: Optional[int] = None,
                 theta: Optional[float] = None, return_cache: bool = False,
                 cache_len: Optional[int] = None):
    """Full-sequence attention (prefill).  x: (B, S, D)."""
    b, s, _ = x.shape
    theta = cfg.rope_theta if theta is None else theta
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, theta)
    out = mha(q, k, v, causal=cfg.causal, window=window,
              softcap=cfg.attn_softcap)
    out = out.reshape(b, s, -1) @ p["wo"].to(x.dtype)
    if not return_cache:
        return out
    cl = cache_len if cache_len is not None else s
    if window is not None:
        cl = min(cl, window)
    return out, KVCache(k=_fit_cache(k, cl), v=_fit_cache(v, cl))


def _fit_cache(k: Tensor, cache_len: int) -> Tensor:
    """The last `cache_len` positions of k (B, S, Hkv, hd), position p at
    slot p % cache_len (the ring decode writes); zeros in unwritten slots."""
    b, s = k.shape[:2]
    out = k.new_zeros((b, cache_len) + tuple(k.shape[2:]))
    first = max(0, s - cache_len)
    pos = torch.arange(first, s, device=k.device)
    out[:, pos % cache_len] = k[:, first:]
    return out


def attn_decode(p: dict, x: Tensor, cache: KVCache, pos: int,
                cfg: ArchConfig, *, window: Optional[int] = None,
                theta: Optional[float] = None):
    """One-token decode.  x: (B, 1, D); pos: host int, the absolute position.

    Local (sliding-window) layers keep a ring cache of `window` slots;
    global layers keep the full-length cache.  The new key and value are
    written into `cache` IN PLACE (one slot; the cache is not copied), and
    (out, cache) is returned.
    """
    b = x.shape[0]
    theta = cfg.rope_theta if theta is None else theta
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, theta)
    s_max = cache.k.shape[1]
    if window is None:
        # valid = pos + 1 as in the reference, which masks nothing more
        # once it passes the cache's length
        slot, valid = min(pos, s_max - 1), min(pos + 1, s_max)
    else:
        # ring: every resident entry is within the window; mask only the
        # unwritten tail early on
        slot, valid = pos % s_max, min(pos + 1, s_max)
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    out = mha(q, cache.k, cache.v, causal=False, softcap=cfg.attn_softcap,
              kv_valid_len=valid, kv_chunk=4096)
    out = out.reshape(b, 1, -1) @ p["wo"].to(x.dtype)
    return out, cache


# ---------------------------------------------------------------------------
# gated cross-attention (Llama-3.2-Vision style)
# ---------------------------------------------------------------------------

def init_cross_attn(cfg: ArchConfig, dtype: torch.dtype,
                    gen: torch.Generator, lead: tuple[int, ...] = ()) -> dict:
    """wq, wk, wv, wo and the gate (1,), zero at init as in the reference
    (tanh(0) = 0: a cross layer adds nothing until trained)."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": dense_init(lead + (d, h * hd), dtype, gen),
            "wk": dense_init(lead + (d, hkv * hd), dtype, gen),
            "wv": dense_init(lead + (d, hkv * hd), dtype, gen),
            "wo": dense_init(lead + (h * hd, d), dtype, gen),
            "gate": torch.zeros(lead + (1,), dtype=dtype,
                                device=gen.device)}


def cross_kv(p: dict, kv_src: Tensor, cfg: ArchConfig,
             dtype: torch.dtype) -> tuple[Tensor, Tensor]:
    """k, v (B, Sv, Hkv, hd) in `dtype` of the vision embeddings kv_src
    (B, Sv, D): what a cross layer attends to, in prefill and decode."""
    b, sv, _ = kv_src.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    src = kv_src.to(dtype)
    k = (src @ p["wk"].to(dtype)).reshape(b, sv, hkv, hd)
    v = (src @ p["wv"].to(dtype)).reshape(b, sv, hkv, hd)
    return k, v


def cross_attn(p: dict, x: Tensor, k: Tensor, v: Tensor,
               cfg: ArchConfig) -> Tensor:
    """tanh(gate) * wo(mha(wq x, k, v)), non-causal over all Sv keys.
    x: (B, S, D) queries (S 1 in decode); k, v from `cross_kv`."""
    b, s, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, cfg.num_heads, cfg.head_dim)
    out = mha(q, k.to(x.dtype), v.to(x.dtype), causal=False)
    out = out.reshape(b, s, -1) @ p["wo"].to(x.dtype)
    return torch.tanh(p["gate"].float()).to(x.dtype) * out


def cross_attn_forward(p: dict, x: Tensor, kv_src: Tensor,
                       cfg: ArchConfig) -> Tensor:
    """x: (B, S, D) queries; kv_src: (B, Sv, D) vision embeddings."""
    k, v = cross_kv(p, kv_src, cfg, x.dtype)
    return cross_attn(p, x, k, v, cfg)
