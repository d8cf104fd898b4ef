"""RWKV-6 (Finch) block: time mix with data-dependent decay, channel mix.

Port of `repro/models/rwkv.py`, the reference's deliberate simplification
of Finch, as it is: static token-shift mixes for r, k, v, g, LoRA
data-dependence on the decay w only, and `ln_x` as one LayerNorm over all
of d_model.  Every WKV recurrence, of prefill and of decode (L = 1), goes
through `ops.wkv`: the rwkv6_scan CUDA kernel for CUDA tensors, the
reference's chunked form (`ref.wkv_chunked_ref`) for CPU tensors.

One deliberate difference: the WKV state is updated in place.  A time mix
given a state reads its `wkv` tensor (B, H, D, D) float32 and overwrites it
with the state after the last token, and returns that same tensor where
the reference returns a new one; without a state it starts from a new
zero tensor.  The decay w and the bonus u stay float32 end to end, as in
the reference (a bfloat16 w near 1 would round to 0.996 or 1.0).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_norm, dense_init, init_norm

Tensor = torch.Tensor


class RWKVState(NamedTuple):
    x_prev_att: Tensor   # (B, D) previous token (time-mix shift)
    x_prev_ffn: Tensor   # (B, D) previous token (channel-mix shift)
    wkv: Tensor          # (B, H, D_head, D_head) float32 state


def init_rwkv(cfg: ArchConfig, dtype: torch.dtype, gen: torch.Generator,
              lead: tuple[int, ...] = ()) -> dict:
    """The reference's leaves and distributions (w0 and u float32), each
    with the leading dims `lead` (a scan group's repeat count)."""
    r = cfg.rwkv
    d = cfg.d_model
    h = d // r.head_size
    dev = gen.device

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=dev)

    return {
        "mix": full((5, d), 0.5, dtype),             # r, k, v, w, g shifts
        "wr": dense_init(lead + (d, d), dtype, gen),
        "wk": dense_init(lead + (d, d), dtype, gen),
        "wv": dense_init(lead + (d, d), dtype, gen),
        "wg": dense_init(lead + (d, d), dtype, gen),
        "wo": dense_init(lead + (d, d), dtype, gen),
        "w0": full((d,), -6.0, torch.float32),       # base decay (large)
        "w_lora_a": dense_init(lead + (d, r.decay_lora), dtype, gen),
        "w_lora_b": dense_init(lead + (r.decay_lora, d), dtype, gen,
                               scale=0.01),
        "u": full((h, r.head_size), 0.0, torch.float32),      # bonus
        "ln_x": init_norm("layernorm", d, dtype, dev, lead),
        "mix_ffn": full((d,), 0.5, dtype),
        "ck": dense_init(lead + (d, cfg.d_ff), dtype, gen),
        "cv": dense_init(lead + (cfg.d_ff, d), dtype, gen),
        "cr": dense_init(lead + (d, d), dtype, gen),
    }


def param_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """Path (under `rwkv.`) and shape of each leaf of one layer."""
    r = cfg.rwkv
    d = cfg.d_model
    return {"mix": (5, d), "wr": (d, d), "wk": (d, d), "wv": (d, d),
            "wg": (d, d), "wo": (d, d), "w0": (d,),
            "w_lora_a": (d, r.decay_lora), "w_lora_b": (r.decay_lora, d),
            "u": (d // r.head_size, r.head_size), "ln_x.scale": (d,),
            "ln_x.bias": (d,), "mix_ffn": (d,), "ck": (d, cfg.d_ff),
            "cv": (cfg.d_ff, d), "cr": (d, d)}


FLOAT32_LEAVES = ("w0", "u")       # float32 whatever the model's dtype


def _shift(x: Tensor, x_prev: Optional[Tensor] = None) -> Tensor:
    """Token shift: x[t-1], zeros (or x_prev) at t = 0.  x: (B, L, D)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, 0])
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _decays(p: dict, xw: Tensor) -> Tensor:
    """Data-dependent per-channel decay in (0, 1), float32:
    exp(-exp(w0 + lora))."""
    lora = torch.tanh(xw @ p["w_lora_a"].to(xw.dtype)) \
        @ p["w_lora_b"].to(xw.dtype)
    logw = p["w0"] + lora.to(torch.float32)
    return torch.exp(-torch.exp(logw))


def _projections(p: dict, x: Tensor, xx: Tensor, h: int, hs: int):
    """r, k, v (B, L, H, hs) in x's dtype, the gate g (B, L, D) and the
    decay w (B, L, H, hs) float32, from x and its shift xx."""
    b, ell, _ = x.shape
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (xx - x) * mix[i] for i in range(5))
    r = (xr @ p["wr"].to(x.dtype)).reshape(b, ell, h, hs)
    k = (xk @ p["wk"].to(x.dtype)).reshape(b, ell, h, hs)
    v = (xv @ p["wv"].to(x.dtype)).reshape(b, ell, h, hs)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    w = _decays(p, xw).reshape(b, ell, h, hs)
    return r, k, v, g, w


def _output(p: dict, out: Tensor, g: Tensor, dtype: torch.dtype) -> Tensor:
    """ln_x over all of d_model (the reference's simplification), the gate
    and the output projection.  out: (B, L, H, hs) in the model's dtype."""
    b, ell = out.shape[:2]
    out = apply_norm("layernorm", p["ln_x"], out.reshape(b, ell, -1))
    return (out * g) @ p["wo"].to(dtype)


def _new_wkv(x: Tensor, cfg: ArchConfig) -> Tensor:
    hs = cfg.rwkv.head_size
    return torch.zeros((x.shape[0], cfg.d_model // hs, hs, hs),
                       dtype=torch.float32, device=x.device)


def rwkv_time_mix(p: dict, x: Tensor, cfg: ArchConfig, *,
                  state: Optional[RWKVState] = None,
                  return_state: bool = False):
    """Time mix (the attention replacement).  x: (B, L, D).  With
    return_state, also the WKV state after the last token (`state.wkv`,
    updated in place, or a new tensor) and x[:, -1]."""
    r_cfg = cfg.rwkv
    hs = r_cfg.head_size
    h = cfg.d_model // hs
    xx = _shift(x, state.x_prev_att if state is not None else None)
    r, k, v, g, w = _projections(p, x, xx, h, hs)
    wkv = state.wkv if state is not None else _new_wkv(x, cfg)
    out = ops.wkv(r, k, v, w, p["u"], wkv, chunk=r_cfg.chunk)
    out = _output(p, out, g, x.dtype)
    if not return_state:
        return out
    return out, wkv, x[:, -1]


def rwkv_channel_mix(p: dict, x: Tensor, *, x_prev: Optional[Tensor] = None,
                     return_state: bool = False):
    """Channel mix (squared-ReLU FFN with token shift)."""
    xx = _shift(x, x_prev)
    mix = p["mix_ffn"].to(x.dtype)
    xk = x + (xx - x) * mix
    kk = F.relu(xk @ p["ck"].to(x.dtype)) ** 2
    out = torch.sigmoid(xk @ p["cr"].to(x.dtype)) * (kk @ p["cv"].to(x.dtype))
    if not return_state:
        return out
    return out, x[:, -1]


def rwkv_decode_time_mix(p: dict, x1: Tensor, state: RWKVState,
                         cfg: ArchConfig):
    """O(1) decode of the time mix: one step of the recurrence (L = 1)
    through `ops.wkv`.  x1: (B, 1, D).  Returns (out (B, 1, D), the state
    `state.wkv` updated in place, x1[:, 0])."""
    hs = cfg.rwkv.head_size
    h = cfg.d_model // hs
    xx = state.x_prev_att[:, None].to(x1.dtype)
    r, k, v, g, w = _projections(p, x1, xx, h, hs)
    out = ops.wkv(r, k, v, w, p["u"], state.wkv, chunk=cfg.rwkv.chunk)
    return _output(p, out, g, x1.dtype), state.wkv, x1[:, 0]
