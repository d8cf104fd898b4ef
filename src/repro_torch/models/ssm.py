"""Mamba-2 block (SSD, state-space duality, chunked) for Zamba2.

Port of `repro/models/ssm.py`.  The reference computes the block in plain
jnp, outside any Pallas kernel, and so does the port in plain PyTorch: the
chunked SSD's within-chunk interactions are masked batched matmuls, and the
state across chunks is a loop over L / chunk steps carrying h (B, H, P, N)
in float32.  Decode is the O(1) recurrent step on (conv state, SSM state).

Under autograd the within-chunk decay is masked before its exp, where the
reference masks after it: the same values, and a finite gradient where the
decays above the diagonal overflow (the reference's is nan there).

The reference's three-operand einsums are written as pairwise steps (the
scores times the decay, then one batched matmul over t), so no
(B, nc, Q, Q, H, P) tensor is formed: at zamba2-7b's prefill (B 2, 40
chunks of 128, H 112, P 64) that would be 37.6 GB in float32, where each
(B, nc, H, Q, Q) factor is 587 MB.  The scores C_s . B_t are computed once
per group of heads (n_groups is 1 in every config) and broadcast over its
heads, as the reference's `jnp.repeat` over groups gives the same dots.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_norm, dense_init, init_norm

Tensor = torch.Tensor

# float32 whatever the model's dtype, as in the reference
FLOAT32_LEAVES = ("A_log", "D", "dt_bias")


class SSMState(NamedTuple):
    conv: Tensor   # (B, conv_width - 1, conv_dim) rolling pre-conv inputs
    ssm: Tensor    # (B, H, P, N) float32 recurrent state


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.state_dim
    return d_inner, n_heads, conv_dim


def init_mamba(cfg: ArchConfig, dtype: torch.dtype, gen: torch.Generator,
               lead: tuple[int, ...] = ()) -> dict:
    """The reference's leaves and distributions, each with the leading dims
    `lead` (a scan group's repeat count).  A_log 0, D 1 and dt_bias 0 are
    float32 constants at init."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    dev = gen.device
    out_dim = d_inner + conv_dim + n_heads       # [z (gate), x, B, C, dt]

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=dev)

    return {
        "in_proj": dense_init(lead + (d, out_dim), dtype, gen),
        "conv_w": dense_init(lead + (s.conv_width, conv_dim), dtype, gen,
                             scale=1.0 / s.conv_width),
        "conv_b": full((conv_dim,), 0.0, dtype),
        "A_log": full((n_heads,), 0.0, torch.float32),     # A = -exp(A_log)
        "D": full((n_heads,), 1.0, torch.float32),
        "dt_bias": full((n_heads,), 0.0, torch.float32),
        "norm": init_norm("rmsnorm", d_inner, dtype, dev, lead),
        "out_proj": dense_init(lead + (d_inner, d), dtype, gen),
    }


def param_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """Path (under `mamba.`) and shape of each leaf of one layer."""
    s = cfg.ssm
    d_inner, n_heads, conv_dim = _dims(cfg)
    return {"in_proj": (cfg.d_model, d_inner + conv_dim + n_heads),
            "conv_w": (s.conv_width, conv_dim), "conv_b": (conv_dim,),
            "A_log": (n_heads,), "D": (n_heads,), "dt_bias": (n_heads,),
            "norm.scale": (d_inner,), "out_proj": (d_inner, cfg.d_model)}


def _split_proj(cfg: ArchConfig, proj: Tensor):
    """(z, xbc, dt) of the input projection."""
    d_inner, _, conv_dim = _dims(cfg)
    return torch.split(proj, [d_inner, conv_dim, proj.shape[-1] - d_inner
                              - conv_dim], dim=-1)


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over (B, L, C) with window len(w), then SiLU."""
    kw, ell = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, kw - 1, 0))
    out = pad[:, 0:ell] * w[0]
    for i in range(1, kw):
        out = out + pad[:, i:i + ell] * w[i]
    return F.silu(out + b)


def _times_group(per_head: Tensor, per_group: Tensor) -> Tensor:
    """per_head (B, nc, H, ...) times per_group (B, nc, G, ...), each
    group's tensor broadcast over its H / G heads."""
    g = per_group.shape[2]
    return (per_head.unflatten(2, (g, -1))
            * per_group.unsqueeze(3)).flatten(2, 3)


def _ssd_chunked(x: Tensor, dt: Tensor, a_log: Tensor, b_mat: Tensor,
                 c_mat: Tensor, d_skip: Tensor, chunk: int,
                 h0: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """SSD scan.  x: (B, L, H, P); dt: (B, L, H) float32; b, c:
    (B, L, G, N).  Returns y (B, L, H, P) in x's dtype and the final state
    (B, H, P, N) float32.  Chunks of q = min(chunk, L); a ragged tail is
    padded with dt = 0 (decay 1, no input)."""
    bsz, ell0, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    q = min(chunk, ell0)
    pad = (-ell0) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    nc = (ell0 + pad) // q
    f32 = torch.float32

    a = -torch.exp(a_log)                                  # (H,)
    dta = dt * a                                           # (B, L, H)
    xb = x * dt[..., None]                                 # float32

    # chunks, heads before positions: (B, nc, H, Q, .)
    xc = xb.reshape(bsz, nc, q, h, p).transpose(2, 3)
    la = torch.cumsum(dta.reshape(bsz, nc, q, h), dim=2).transpose(2, 3)
    bc = b_mat.reshape(bsz, nc, q, g, n).transpose(2, 3).to(f32)
    cc = c_mat.reshape(bsz, nc, q, g, n).transpose(2, 3).to(f32)

    # within a chunk: y_s = sum_{t <= s} exp(la_s - la_t) (C_s . B_t) x_t.
    # Above the diagonal seg = -(the decays between) > 0, and its exp
    # overflows to inf once they pass ~88: masked before the exp, so the
    # gradient there is 0 * exp(-inf) = 0, not 0 * inf = nan (the
    # reference's jnp.where after the exp gives nan at that point).  The
    # values are the same bits either way.
    seg = la[..., :, None] - la[..., None, :]              # (B, nc, H, Q, Q)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal, seg, float("-inf")))
    del seg
    y = _times_group(decay, cc @ bc.transpose(-1, -2)) @ xc  # (B,nc,H,Q,P)
    del decay

    # chunk states: sum_t exp(la_last - la_t) B_t x_t   (B, nc, H, P, N)
    last = la[..., -1:]                                    # (B, nc, H, 1)
    states = xc.transpose(-1, -2) @ _times_group(
        torch.exp(last - la)[..., None], bc)
    chunk_decay = torch.exp(last[..., 0])                  # (B, nc, H)

    h_run = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h_run)
        h_run = h_run * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                   # (B, nc, H, P, N)

    # across chunks: y_s += exp(la_s) C_s . h_prev
    y = y + _times_group(torch.exp(la)[..., None], cc) \
        @ h_prev.transpose(-1, -2)
    y = y.transpose(2, 3).reshape(bsz, nc * q, h, p)
    y = y + d_skip[None, None, :, None] * x.to(f32)
    return y[:, :ell0].to(x.dtype), h_run


def mamba_forward(p: dict, x: Tensor, cfg: ArchConfig, *,
                  return_state: bool = False):
    """Prefill / full-sequence forward.  x: (B, L, D).  With return_state,
    also the SSMState after the last token: the last conv_width - 1
    pre-conv inputs (left-padded with zeros when L is shorter) and h."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    bsz, ell, _ = x.shape
    gn = s.n_groups * s.state_dim
    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc_raw, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(x.dtype),
                       p["conv_b"].to(x.dtype))
    xi, b_mat, c_mat = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    xi = xi.reshape(bsz, ell, n_heads, s.head_dim)
    b_mat = b_mat.reshape(bsz, ell, s.n_groups, s.state_dim)
    c_mat = c_mat.reshape(bsz, ell, s.n_groups, s.state_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])
    y, h_last = _ssd_chunked(xi, dt, p["A_log"], b_mat, c_mat, p["D"],
                             s.chunk)
    y = y.reshape(bsz, ell, d_inner)
    y = apply_norm("rmsnorm", p["norm"], y * F.silu(z))
    out = y @ p["out_proj"].to(x.dtype)
    if not return_state:
        return out
    kw = s.conv_width - 1
    conv_state = xbc_raw[:, -kw:] if ell >= kw \
        else F.pad(xbc_raw, (0, 0, kw - ell, 0))
    return out, SSMState(conv=conv_state, ssm=h_last)


def mamba_decode(p: dict, x: Tensor, state: SSMState, cfg: ArchConfig):
    """Single-token recurrent step.  x: (B, 1, D).  Returns (out (B, 1, D),
    the new SSMState); `state` is not written."""
    s = cfg.ssm
    d_inner, n_heads, _ = _dims(cfg)
    bsz = x.shape[0]
    gn = s.n_groups * s.state_dim
    proj = x @ p["in_proj"].to(x.dtype)                    # (B, 1, out)
    z, xbc_new, dt = _split_proj(cfg, proj)

    window = torch.cat([state.conv.to(x.dtype), xbc_new], dim=1)
    w = p["conv_w"].to(x.dtype)
    conv_out = (window * w).sum(dim=1) + p["conv_b"].to(x.dtype)
    xbc = F.silu(conv_out)[:, None]                        # (B, 1, conv_dim)

    xi, b_mat, c_mat = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    xi = xi.reshape(bsz, n_heads, s.head_dim)
    rep = n_heads // s.n_groups
    b_mat = b_mat.reshape(bsz, s.n_groups, s.state_dim).repeat_interleave(
        rep, dim=1).float()
    c_mat = c_mat.reshape(bsz, s.n_groups, s.state_dim).repeat_interleave(
        rep, dim=1).float()
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])     # (B, H)
    dec = torch.exp(dt1 * -torch.exp(p["A_log"]))
    xb = xi.float() * dt1[..., None]
    h = state.ssm * dec[:, :, None, None] + xb[..., None] * b_mat[:, :, None]
    y = (h @ c_mat[..., None])[..., 0]                     # (B, H, P)
    y = y + p["D"][None, :, None] * xi.float()
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = apply_norm("rmsnorm", p["norm"], y * F.silu(z))
    out = y @ p["out_proj"].to(x.dtype)
    return out, SSMState(conv=window[:, 1:], ssm=h)
