"""Mixture-of-Experts FFN: softmax top-k routing with the Switch aux loss,
the routed experts and the always-on shared expert.

Port of the single-host path of `repro/models/moe.py` (`init_moe`,
`_router`, `_expert_ffn`, `_shared_expert`, `moe_dense`, `moe_apply`
without a mesh).  The reference's dropless `moe_dense` runs every expert
on every token and zeroes the others with the gates; at deepseek-v3's
width that is a (256, N, 7168) broadcast, 36.7 GB and ~2.2 PFLOP a layer
at N = 10000.  The port computes the same function by routing: the N*k
(token, expert) pairs are sorted by expert (stably, so a token's pairs
keep their order), each expert's rows are gathered and run through one
product of each of w_in, w_gate and w_out on its contiguous slice, each
pair's output goes back to its (token, slot) place, and the k slots are
summed in float32 in slot order (no atomics: runs on the card are
deterministic) and rounded to the model's dtype.  The reference's gates
are zero outside the top k, so this is its function up to the order of
its sums.  The experts' products are cuBLAS's; no Pallas kernel of the
reference computes the MoE.

The expert-parallel path (`moe_ep`, its capacity dispatch and the mesh
context) is ROADMAP item 11(i): `moe_apply` raises when given a mesh.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import activate, dense_init, is_gated

Tensor = torch.Tensor


def _expert_init(shape: tuple[int, ...], dtype: torch.dtype,
                 gen: torch.Generator) -> Tensor:
    """`dense_init` of a stacked (..., d_in, d_out) expert weight, one
    (d_in, d_out) matrix at a time: the float32 draw of a whole stack
    (33.8 GB for dbrx-132b's w_in at 8 layers) does not fit the card
    beside its bf16 result."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for mat in out.view(-1, *shape[-2:]):
        mat.copy_(dense_init(shape[-2:], dtype, gen))
    return out


def init_moe(cfg: ArchConfig, dtype: torch.dtype, gen: torch.Generator,
             lead: tuple[int, ...] = ()) -> dict:
    """router (D, E) float32 (in any model dtype, as the reference keeps
    it), w_in, w_gate (E, D, F) and w_out (E, F, D), and with shared
    experts shared_in, shared_gate (D, F * num_shared) and shared_out."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.num_experts
    p = {"router": dense_init(lead + (d, e), torch.float32, gen),
         "w_in": _expert_init(lead + (e, d, f), dtype, gen),
         "w_out": _expert_init(lead + (e, f, d), dtype, gen)}
    if is_gated(cfg.activation):
        p["w_gate"] = _expert_init(lead + (e, d, f), dtype, gen)
    if m.num_shared:
        fs = f * m.num_shared
        p["shared_in"] = dense_init(lead + (d, fs), dtype, gen)
        p["shared_out"] = dense_init(lead + (fs, d), dtype, gen)
        if is_gated(cfg.activation):
            p["shared_gate"] = dense_init(lead + (d, fs), dtype, gen)
    return p


def param_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """The leaves `init_moe` makes, by name."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.num_experts
    out = {"router": (d, e), "w_in": (e, d, f), "w_out": (e, f, d)}
    if is_gated(cfg.activation):
        out["w_gate"] = (e, d, f)
    if m.num_shared:
        fs = f * m.num_shared
        out.update(shared_in=(d, fs), shared_out=(fs, d))
        if is_gated(cfg.activation):
            out["shared_gate"] = (d, fs)
    return out


FLOAT32_LEAVES = ("router",)


def _router(router_w: Tensor, x2: Tensor, m) -> tuple[Tensor, Tensor,
                                                      Tensor]:
    """x2 (N, D) -> (top-k weights (N, k) in x2's dtype, top-k expert ids
    (N, k), the Switch aux loss).  The logits are a float32 product (TF32
    must be off: a flipped choice moves a token's output by O(1)); the k
    experts are taken by a stable descending sort, so equal probabilities
    pick the lower expert id first, as `jax.lax.top_k` does."""
    logits = x2.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                      # (N, E)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :m.top_k], idx[:, :m.top_k]
    w = w / torch.sum(w, dim=-1, keepdim=True)                 # renormalize
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    e = probs.shape[-1]
    occupancy = torch.bincount(idx.reshape(-1), minlength=e).float() \
        / x2.shape[0]
    importance = torch.mean(probs, dim=0)
    aux = e * torch.sum(occupancy * importance)
    return w.to(x2.dtype), idx, aux


def _expert_ffn(x: Tensor, w_in: Tensor, w_out: Tensor,
                w_gate: Tensor | None, activation: str) -> Tensor:
    """One expert on its rows x (C, D): weights (D, F) / (F, D)."""
    up = x @ w_in.to(x.dtype)
    gate = x @ w_gate.to(x.dtype) if w_gate is not None else None
    return activate(activation, up, gate) @ w_out.to(x.dtype)


def _shared_expert(sh_in: Tensor, sh_out: Tensor, sh_gate: Tensor | None,
                   x: Tensor, activation: str) -> Tensor:
    up = x @ sh_in.to(x.dtype)
    gate = x @ sh_gate.to(x.dtype) if sh_gate is not None else None
    return activate(activation, up, gate) @ sh_out.to(x.dtype)


def routed_experts(p: dict, x2: Tensor, w: Tensor, idx: Tensor,
                   activation: str) -> Tensor:
    """sum_j w[n, j] * expert_{idx[n, j]}(x2[n]) for x2 (N, D), w and idx
    (N, k): the pairs sorted by expert, one product of each weight an
    expert on its contiguous rows (an expert with no pair is skipped; the
    per-expert counts are read on the host, one sync a call), each output
    back at its (token, slot) place, the slots summed in float32 in slot
    order and rounded to x2's dtype."""
    n, d = x2.shape
    k = idx.shape[1]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)        # pair ids by expert
    counts = torch.bincount(flat, minlength=p["w_in"].shape[0]).tolist()
    rows = x2[order // k]                           # (N*k, D) by expert
    out = torch.empty_like(rows)
    w_gate = p.get("w_gate")
    start = 0
    for e, c in enumerate(counts):
        if c:
            out[start:start + c] = _expert_ffn(
                rows[start:start + c], p["w_in"][e], p["w_out"][e],
                None if w_gate is None else w_gate[e], activation)
            start += c
    out = out[torch.argsort(order)].view(n, k, d)   # back to (token, slot)
    acc = torch.zeros((n, d), dtype=torch.float32, device=x2.device)
    wf = w.float()
    for j in range(k):
        acc += wf[:, j, None] * out[:, j].float()
    return acc.to(x2.dtype)


def moe_dense(p: dict, x: Tensor, cfg: ArchConfig) -> tuple[Tensor, Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux): the reference's dropless MoE
    (every token's k experts, weighted, plus the shared experts), by
    routing."""
    m = cfg.moe
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    w, idx, aux = _router(p["router"], x2, m)
    y = routed_experts(p, x2, w, idx, cfg.activation)
    if m.num_shared:
        y = y + _shared_expert(p["shared_in"], p["shared_out"],
                               p.get("shared_gate"), x2, cfg.activation)
    return y.reshape(b, s, d), aux


def moe_apply(p: dict, x: Tensor, cfg: ArchConfig,
              mesh=None) -> tuple[Tensor, Tensor]:
    """The MoE FFN on one device (`moe_dense`); a mesh (the
    expert-parallel path) raises."""
    if mesh is not None:
        raise NotImplementedError(
            f"{cfg.name}: the expert-parallel MoE (moe_ep) is not ported "
            "yet (ROADMAP.md, Queue 1 item 11(i))")
    return moe_dense(p, x, cfg)
