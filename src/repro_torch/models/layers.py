"""Shared layer primitives: norms, activations, RoPE, embeddings, dense FFN.

Port of `repro/models/layers.py`.  Params are plain dicts of tensors; init
functions fill them from an explicit `torch.Generator` with the reference's
distributions and scales (the bits differ: the reference draws from
`jax.random`).  Compute follows the input's dtype; the norms, RoPE and the
softcap of the logits run in float32 as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# ----------------------------------------------------------------- init ----

def dense_init(shape: tuple[int, ...], dtype: torch.dtype,
               gen: torch.Generator, scale: float | None = None) -> Tensor:
    """Truncated-normal ([-2, 2]) fan-in init; fan_in is shape[-2], so a
    stacked (n, d_in, d_out) tensor is n layers of (d_in, d_out)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def embed_init(vocab: int, dim: int, dtype: torch.dtype,
               gen: torch.Generator) -> Tensor:
    t = torch.randn((vocab, dim), dtype=torch.float32, device=gen.device,
                    generator=gen)
    return (t / math.sqrt(dim)).to(dtype)


# ----------------------------------------------------------------- norms ---

def init_norm(kind: str, dim: int, dtype: torch.dtype,
              device: torch.device, lead: tuple[int, ...] = ()) -> dict:
    p = {"scale": torch.ones(lead + (dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (dim,), dtype=dtype, device=device)
    return p


def apply_norm(kind: str, p: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm (a plain `scale`, not 1 + scale) or LayerNorm, in float32."""
    x32 = x.float()
    if kind == "rmsnorm":
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    elif kind == "layernorm":
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
        out = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"].float() \
            + p["bias"].float()
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


# ------------------------------------------------------------ activations --

def activate(name: str, up: Tensor, gate: Optional[Tensor]) -> Tensor:
    """jax.nn.gelu defaults to the tanh approximation, and so does this."""
    if name == "swiglu":
        return F.silu(gate) * up
    if name == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if name == "relu2":
        r = F.relu(up)
        return r * r
    if name == "gelu":
        return F.gelu(up, approximate="tanh")
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


# ----------------------------------------------------------------- FFN -----

def init_ffn(d_model: int, d_ff: int, activation: str, dtype: torch.dtype,
             gen: torch.Generator, lead: tuple[int, ...] = ()) -> dict:
    p = {"w_in": dense_init(lead + (d_model, d_ff), dtype, gen),
         "w_out": dense_init(lead + (d_ff, d_model), dtype, gen)}
    if is_gated(activation):
        p["w_gate"] = dense_init(lead + (d_model, d_ff), dtype, gen)
    return p


def apply_ffn(p: dict, x: Tensor, activation: str) -> Tensor:
    up = x @ p["w_in"].to(x.dtype)
    gate = x @ p["w_gate"].to(x.dtype) if "w_gate" in p else None
    h = activate(activation, up, gate)
    return h @ p["w_out"].to(x.dtype)


# ----------------------------------------------------------------- RoPE ----

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, hd), positions broadcastable to (..., S).  Each head
    is split into two halves (not interleaved), rotated in float32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- softcap ----

def softcap(x: Tensor, cap: Optional[float]) -> Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
