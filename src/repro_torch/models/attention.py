"""GQA attention (full, sliding-window, softcap) for prefill and decode,
gated cross-attention (Llama-3.2-Vision style), and DeepSeek's MLA.

Port of the GQA, cross-attention and MLA parts of
`repro/models/attention.py`.  Every prefill attention call goes through
`ops.mha`: the flash-attention CUDA kernel for CUDA tensors, the plain
chunked online softmax (`ref.mha_ref`) for CPU tensors.  MLA's decode is
the reference's absorbed form in plain PyTorch (float32 products over the
latent cache; the reference's is plain jnp too).  With
`cfg.kv_cache_dtype == "int8"` a GQA cache holds int8 values and a float32
absmax scale a (position, kv head) (`quantize_kv`, plain PyTorch as the
reference's is jnp): prefill attends over the float k and v and stores
them quantized, and decode quantizes the new entry and attends over the
cache dequantized into the model dtype, as the reference's
`attn_decode_sharded` does at a degenerate mesh (its mesh-less
`attn_decode` drops the scales; ROADMAP Queue 3).  The sharded decodes
are ROADMAP item 11(i).

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
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (apply_norm, apply_rope, dense_init,
                                       init_norm)

Tensor = torch.Tensor


class KVCache(NamedTuple):
    """Per-layer KV cache.  k/v: (B, S_max, Hkv, hd); a ring of `window`
    slots on sliding-window layers.  With the int8 cache k/v are int8 and
    k_scale/v_scale (B, S_max, Hkv) float32 their dequantization scales;
    None otherwise."""
    k: Tensor
    v: Tensor
    k_scale: Optional[Tensor] = None
    v_scale: Optional[Tensor] = None


def quantize_kv(t: Tensor) -> tuple[Tensor, Tensor]:
    """t (..., hd) -> int8 values and the float32 absmax scale over hd:
    scale = max(amax, 1e-8) / 127, values round-half-even(t / scale)
    clipped to +-127, as the reference's."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.round(tf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_kv(q: Tensor, scale: Tensor, dtype: torch.dtype) -> Tensor:
    """int8 values (..., hd) times their scale (...) in float32, then cast
    to `dtype`: the reference's two roundings."""
    return (q.float() * scale[..., None]).to(dtype)


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
    kf, vf = _fit_cache(k, cl), _fit_cache(v, cl)
    if cfg.kv_cache_dtype == "int8":
        # quantized after fitting: the scales are per (position, head), so
        # the ring and the quantization compose; an unwritten slot is 0
        # values at the 1e-8 / 127 scale, as in the reference
        kq, ks = quantize_kv(kf)
        vq, vs = quantize_kv(vf)
        return out, KVCache(k=kq, v=vq, k_scale=ks, v_scale=vs)
    return out, KVCache(k=kf, v=vf)


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
    (out, cache) is returned.  An int8 cache takes the new entry quantized,
    values and scales, and is read dequantized into q's dtype.
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
    if cache.k_scale is None:
        cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
        k, v = cache.k, cache.v
    else:
        for vals, scales, new in ((cache.k, cache.k_scale, k_new),
                                  (cache.v, cache.v_scale, v_new)):
            nq, ns = quantize_kv(new[:, 0])
            vals[:, slot] = nq
            scales[:, slot] = ns
        # only the `valid` written slots are dequantized: the masked tail
        # does not enter the result
        k = dequantize_kv(cache.k[:, :valid], cache.k_scale[:, :valid],
                          q.dtype)
        v = dequantize_kv(cache.v[:, :valid], cache.v_scale[:, :valid],
                          q.dtype)
    out = mha(q, k, v, causal=False, softcap=cfg.attn_softcap,
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


# ---------------------------------------------------------------------------
# DeepSeek MLA (multi-head latent attention) + absorbed decode
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    """Compressed cache: c_kv (B, S_max, kv_lora), k_rope (B, S_max,
    rope_dim)."""
    c_kv: Tensor
    k_rope: Tensor


def mla_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """The leaves `init_mla` makes, by path."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {"wq_a": (d, m.q_lora_rank), "q_norm.scale": (m.q_lora_rank,),
            "wq_b": (m.q_lora_rank, h * qk),
            "wkv_a": (d, m.kv_lora_rank + m.qk_rope_head_dim),
            "kv_norm.scale": (m.kv_lora_rank,),
            "wk_b": (m.kv_lora_rank, h * m.qk_nope_head_dim),
            "wv_b": (m.kv_lora_rank, h * m.v_head_dim),
            "wo": (h * m.v_head_dim, d)}


def init_mla(cfg: ArchConfig, dtype: torch.dtype, gen: torch.Generator,
             lead: tuple[int, ...] = ()) -> dict:
    p: dict = {}
    for path, shape in mla_shapes(cfg).items():
        if path.endswith(".scale"):
            p[path.split(".")[0]] = init_norm("rmsnorm", shape[0], dtype,
                                              gen.device, lead)
        else:
            p[path] = dense_init(lead + shape, dtype, gen)
    return p


def _mla_q(p: dict, x: Tensor, cfg: ArchConfig, positions: Tensor):
    m = cfg.mla
    b, s, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_lat = apply_norm("rmsnorm", p["q_norm"], x @ p["wq_a"].to(x.dtype))
    q = (q_lat @ p["wq_b"].to(x.dtype)).reshape(b, s, cfg.num_heads, qk)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_kv_latent(p: dict, x: Tensor, cfg: ArchConfig, positions: Tensor):
    m = cfg.mla
    kv = x @ p["wkv_a"].to(x.dtype)
    c_kv, k_rope = torch.split(kv, [m.kv_lora_rank, m.qk_rope_head_dim],
                               dim=-1)
    c_kv = apply_norm("rmsnorm", p["kv_norm"], c_kv)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]           # shared head
    return c_kv, k_rope


def mla_forward(p: dict, x: Tensor, cfg: ArchConfig, *,
                return_cache: bool = False, cache_len: Optional[int] = None):
    """Prefill MLA: decompress K and V and run standard attention, q and k
    at nope + rope columns (192 at deepseek-v3's width), v zero-padded to
    them (`_mha_mixed_dims`)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_kv_latent(p, x, cfg, positions)
    k_nope = (c_kv @ p["wk_b"].to(x.dtype)).reshape(b, s, h,
                                                    m.qk_nope_head_dim)
    v = (c_kv @ p["wv_b"].to(x.dtype)).reshape(b, s, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    out = _mha_mixed_dims(q, k, v, causal=cfg.causal)
    out = out.reshape(b, s, -1) @ p["wo"].to(x.dtype)
    if not return_cache:
        return out
    cl = cache_len if cache_len is not None else s
    return out, MLACache(c_kv=_fit2(c_kv, cl), k_rope=_fit2(k_rope, cl))


def _fit2(a: Tensor, cl: int) -> Tensor:
    """The last cl positions of a (B, S, d), zero-padded at the end when
    S < cl: position p at slot p, as `mla_decode` writes them."""
    s = a.shape[1]
    if s >= cl:
        return a[:, s - cl:]
    return torch.nn.functional.pad(a, (0, 0, 0, cl - s))


def _mha_mixed_dims(q: Tensor, k: Tensor, v: Tensor, *,
                    causal: bool) -> Tensor:
    """`mha` where v's head dim is below q's and k's (MLA): v zero-padded
    to theirs, the output's padded columns dropped."""
    dq, dv = q.shape[-1], v.shape[-1]
    if dv == dq:
        return mha(q, k, v, causal=causal)
    v_p = torch.nn.functional.pad(v, (0, dq - dv))
    return mha(q, k, v_p, causal=causal)[..., :dv]


def mla_decode(p: dict, x: Tensor, cache: MLACache, pos: int,
               cfg: ArchConfig):
    """Absorbed MLA decode: attend in the compressed latent space.

    score_t = q_nope^T (wk_b c_t) + q_rope^T kr_t
            = (wk_b^T q_nope)^T c_t + q_rope^T kr_t
    so K is never decompressed; the output is combined in latent space and
    decompressed once through wv_b.  x: (B, 1, D); pos: host int.  The new
    latent and rope key are written into `cache` IN PLACE at slot
    min(pos, S_max - 1), and the scores, softmax and latent sum run in
    float32 over the whole cache, masked past pos, as the reference's."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)          # (B, 1, H, *)
    c_new, kr_new = _mla_kv_latent(p, x, cfg, positions)   # (B, 1, *)
    s_max = cache.c_kv.shape[1]
    slot = min(pos, s_max - 1)
    cache.c_kv[:, slot] = c_new[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, slot] = kr_new[:, 0].to(cache.k_rope.dtype)
    c, kr = cache.c_kv.float(), cache.k_rope.float()

    wk_b = p["wk_b"].to(x.dtype).reshape(m.kv_lora_rank, h,
                                         m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope, wk_b)   # (B, 1, H, lora)
    scale = 1.0 / torch.sqrt(torch.tensor(
        m.qk_nope_head_dim + m.qk_rope_head_dim, dtype=torch.float32,
        device=x.device))
    logits = (torch.einsum("bqhl,bsl->bhqs", q_lat.float(), c)
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr)) * scale
    mask = torch.arange(s_max, device=x.device) <= pos
    logits = torch.where(mask, logits, torch.tensor(NEG_INF,
                                                    device=x.device))
    probs = torch.softmax(logits, dim=-1)
    out_lat = torch.einsum("bhqs,bsl->bqhl", probs, c)      # (B, 1, H, lora)
    wv_b = p["wv_b"].to(x.dtype).reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bqhl,lhv->bqhv", out_lat.to(x.dtype), wv_b)
    out = out.reshape(b, 1, -1) @ p["wo"].to(x.dtype)
    return out, cache
