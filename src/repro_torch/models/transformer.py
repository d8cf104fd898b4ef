"""Transformer assembly: scan groups of blocks, embedding and LM head.

Port of `repro/models/transformer.py` for the block kinds attn, local,
global (dense attention), rwkv, mamba, shared_attn, cross and moe (MLA
attention in every attention block of an MLA config), and for the audio
encoder (hubert-xlarge: `embed_audio` takes precomputed frame
features (B, S, feature_dim), the reference's stub of the conv frontend,
in place of the token embedding).  The model is a `torch.nn.Module` whose
parameter tree mirrors the reference's pytree: a scan group's leaves are
stacked over its repeat count, as `jax.vmap(init_period)` stacks them, so

    embed (V, D), final_norm.scale (D,),
    group{gi}.b{i}.norm1.scale (n, D), group{gi}.b{i}.attn.wq (n, D, H*hd),
    group{gi}.b{i}.ffn.w_in (n, D, F), ...

are both the state_dict keys here and the '.'-joined pytree paths there
(`interop.lm_params_from_numpy` maps one to the other); an MTP config
(deepseek-v3-671b) also has the reference's `mtp` leaves (proj, an
attention block without the stacking, norm), which serving never reads.
Layer l of a group reads the views leaf.unbind(0)[l] (`unstack`); under
autograd the unbind gathers the layers' gradients into the stacked leaf's
in one step.

`forward` is the training forward (loss and the pooled state for the MTL
probes), with the reference's remat at its scan body's granularity (a
period of blocks) through `torch.utils.checkpoint`.  Every ported block
kind trains:

- attn, local, global: the flash kernels forward, `flash_attention_bwd`
  backward, through `ops.mha`'s autograd Function; with MLA
  (deepseek-v3-671b) q and k at nope + rope columns and v zero-padded to
  them (`attention.mla_forward`), the padded columns' gradient dropped;
- rwkv: the WKV kernels forward, `rwkv6_bwd` backward, through `ops.wkv`;
- mamba: the Mamba-2 SSD in plain PyTorch (as the reference's is plain
  jnp, with no Pallas kernel), differentiated by autograd;
- shared_attn: Zamba2's weight-tied attention and FFN (the top-level
  `shared_attn` params, read through `Extras` in each remat region) with
  this invocation's LoRA merged into wq and wo at every call
  (`shared_attn_params`), so the tied leaves' gradient is summed over the
  invocations by autograd and the LoRA a and b leaves get theirs;
- cross: the self-attention, then the gated cross-attention over the
  vision embeddings (a leaf with no gradient), both through `ops.mha`;
- moe (dbrx-132b, deepseek-v3-671b): the routed MoE FFN of
  `models/moe.py` under autograd (cuBLAS's products, as the reference's
  are plain jnp), its Switch aux loss summed by `backbone_forward` and
  added to the loss at aux_loss_weight.

An MTP config (deepseek-v3-671b) adds the reference's multi-token
prediction loss (`_mtp_loss`, outside remat as there) at mtp_weight.  The
expert-parallel MoE and the sharded LM are ROADMAP item 11(i); they
raise.  A config with the int8 KV cache (`kv_cache_dtype="int8"`) trains
exactly as its model-dtype twin: training builds no cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_ffn, apply_norm, dense_init,
                                       embed_init, init_ffn, init_norm,
                                       is_gated, softcap)

Tensor = torch.Tensor

PORTED_KINDS = ("attn", "local", "global", "rwkv", "mamba", "shared_attn",
                "cross", "moe")
TRAINED_KINDS = ("attn", "local", "global", "rwkv", "mamba", "shared_attn",
                 "cross", "moe")

LORA_RANK = 64   # Zamba2 shared-attention per-invocation LoRA rank


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


def require_ported(cfg: ArchConfig, training: bool = False) -> None:
    """Raise for a config that needs a block kind the port does not have
    yet: a kind outside PORTED_KINDS or a moe block without its MoE
    config; with `training`, also for a kind outside TRAINED_KINDS.  The
    KV cache is "model" (cfg.dtype) or "int8" (`attention.quantize_kv`),
    serving and training alike; any other value raises ValueError."""
    kinds = set(cfg.layer_kinds) - set(PORTED_KINDS)
    if kinds or ("moe" in cfg.layer_kinds and cfg.moe is None):
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds)} (or a moe block "
            "without cfg.moe) are not ported (ROADMAP.md, Queue 1 item 11)")
    if cfg.kv_cache_dtype not in ("model", "int8"):
        raise ValueError(f"{cfg.name}: kv_cache_dtype "
                         f"{cfg.kv_cache_dtype!r}, want 'model' or 'int8'")
    untrained = set(cfg.layer_kinds) - set(TRAINED_KINDS)
    if training and untrained:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(untrained)} serve but do not "
            "train in the port (ROADMAP.md, Queue 1 item 11)")


class ParamTree(nn.Module):
    """A nested dict of tensors held as parameters, so that the state_dict
    keys are the '.'-joined paths of the dict.  They are made frozen
    (serving); training turns them on with `requires_grad_(True)`."""

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


def unstack(tree: dict, n: int) -> list[dict]:
    """The n layers of a stacked tree, each leaf's views from one
    `unbind(0)` (one backward step for the stacked leaf's gradient)."""
    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        return node.unbind(0)

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    parts = split(tree)
    return [pick(parts, i) for i in range(n)]


def _init_block(kind: BlockKind, cfg: ArchConfig, dtype: torch.dtype,
                gen: torch.Generator, lead: tuple[int, ...]) -> dict:
    d, dev = cfg.d_model, gen.device
    if kind == "rwkv":
        return {"norm1": init_norm(cfg.norm, d, dtype, dev, lead),
                "norm2": init_norm(cfg.norm, d, dtype, dev, lead),
                "rwkv": rwkv_lib.init_rwkv(cfg, dtype, gen, lead)}
    if kind == "mamba":
        return {"norm1": init_norm(cfg.norm, d, dtype, dev, lead),
                "mamba": ssm_lib.init_mamba(cfg, dtype, gen, lead)}
    if kind == "shared_attn":
        # per-invocation params only: LoRA deltas on wq / wo and the norms
        hq = cfg.num_heads * cfg.head_dim
        return {"norm1": init_norm(cfg.norm, d, dtype, dev, lead),
                "norm2": init_norm(cfg.norm, d, dtype, dev, lead),
                "lora_q_a": dense_init(lead + (d, LORA_RANK), dtype, gen),
                "lora_q_b": dense_init(lead + (LORA_RANK, hq), dtype, gen,
                                       scale=0.0),
                "lora_o_a": dense_init(lead + (hq, LORA_RANK), dtype, gen),
                "lora_o_b": dense_init(lead + (LORA_RANK, d), dtype, gen,
                                       scale=0.0)}
    p = {"norm1": init_norm(cfg.norm, d, dtype, dev, lead),
         "attn": (attn_lib.init_mla if cfg.mla else attn_lib.init_attn)(
             cfg, dtype, gen, lead),
         "norm2": init_norm(cfg.norm, d, dtype, dev, lead)}
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(cfg, dtype, gen, lead)
    else:
        p["ffn"] = init_ffn(d, cfg.d_ff, cfg.activation, dtype, gen, lead)
    if kind == "cross":
        p["norm_x"] = init_norm(cfg.norm, d, dtype, dev, lead)
        p["xattn"] = attn_lib.init_cross_attn(cfg, dtype, gen, lead)
    return p


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
    truncated-normal fan-in matrices, N(0, 1/D) embeddings, unit norms.
    An audio model also gets the frame projection `feat_proj` and a zero
    `mask_emb`, and keeps the `embed` its forward never reads, and an MTP
    model its `mtp` leaves, as the reference's tree does."""
    require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    tree: dict = {}
    if cfg.feature_dim:
        tree["feat_proj"] = dense_init((cfg.feature_dim, cfg.d_model), dtype,
                                       gen)
        tree["mask_emb"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                       device=dev)
    tree["embed"] = embed_init(cfg.vocab_size, cfg.d_model, dtype, gen)
    if not cfg.tie_embeddings:
        tree["unembed"] = dense_init((cfg.d_model, cfg.vocab_size), dtype,
                                     gen)
    tree["final_norm"] = init_norm(cfg.norm, cfg.d_model, dtype, dev)
    if "shared_attn" in cfg.layer_kinds:
        tree["shared_attn"] = {
            "attn": attn_lib.init_attn(cfg, dtype, gen),
            "ffn": init_ffn(cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                            gen)}
    for gi, group in enumerate(scan_groups(cfg)):
        tree[f"group{gi}"] = {
            f"b{i}": _init_block(kind, cfg, dtype, gen, (group.n,))
            for i, kind in enumerate(group.period)}
    if cfg.mtp:
        tree["mtp"] = {
            "proj": dense_init((2 * cfg.d_model, cfg.d_model), dtype, gen),
            "block": _init_block("attn", cfg, dtype, gen, ()),
            "norm": init_norm(cfg.norm, cfg.d_model, dtype, dev)}
    return LM(cfg, tree)


def _norm_shapes(cfg: ArchConfig, name: str, dim: int) -> dict:
    out = {f"{name}.scale": (dim,)}
    if cfg.norm == "layernorm":
        out[f"{name}.bias"] = (dim,)
    return out


def _attn_ffn_shapes(cfg: ArchConfig, kind: BlockKind = "attn") -> dict:
    """Leaves of an attention block's attn (MLA's where cfg.mla) and ffn
    (a moe block's moe)."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.mla:
        out = {f"attn.{k}": v for k, v in attn_lib.mla_shapes(cfg).items()}
    else:
        out = {"attn.wq": (d, h * hd), "attn.wk": (d, hkv * hd),
               "attn.wv": (d, hkv * hd), "attn.wo": (h * hd, d)}
        if cfg.qk_norm:
            out["attn.q_norm.scale"] = out["attn.k_norm.scale"] = (hd,)
    if kind == "moe":
        out.update({f"moe.{k}": v
                    for k, v in moe_lib.param_shapes(cfg).items()})
        return out
    out.update({"ffn.w_in": (d, cfg.d_ff), "ffn.w_out": (cfg.d_ff, d)})
    if is_gated(cfg.activation):
        out["ffn.w_gate"] = (d, cfg.d_ff)
    return out


def _block_shapes(kind: BlockKind, cfg: ArchConfig) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    norms = ("norm1",) if kind == "mamba" else ("norm1", "norm2")
    if kind == "rwkv":
        block = {f"rwkv.{k}": v
                 for k, v in rwkv_lib.param_shapes(cfg).items()}
    elif kind == "mamba":
        block = {f"mamba.{k}": v
                 for k, v in ssm_lib.param_shapes(cfg).items()}
    elif kind == "shared_attn":
        block = {"lora_q_a": (d, LORA_RANK), "lora_q_b": (LORA_RANK, h * hd),
                 "lora_o_a": (h * hd, LORA_RANK), "lora_o_b": (LORA_RANK, d)}
    else:
        block = _attn_ffn_shapes(cfg, kind)
        if kind == "cross":
            norms += ("norm_x",)
            block.update({"xattn.wq": (d, h * hd), "xattn.wk": (d, hkv * hd),
                          "xattn.wv": (d, hkv * hd),
                          "xattn.wo": (h * hd, d), "xattn.gate": (1,)})
    for nm in norms:
        block.update(_norm_shapes(cfg, nm, d))
    return block


def param_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """The path and shape of every parameter `init_params` makes."""
    require_ported(cfg)
    d = cfg.d_model
    shapes = {}
    if cfg.feature_dim:
        shapes.update(feat_proj=(cfg.feature_dim, d), mask_emb=(d,))
    shapes["embed"] = (cfg.vocab_size, d)
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.vocab_size)
    shapes.update(_norm_shapes(cfg, "final_norm", d))
    if "shared_attn" in cfg.layer_kinds:
        shapes.update({f"shared_attn.{k}": v
                       for k, v in _attn_ffn_shapes(cfg).items()})
    for gi, group in enumerate(scan_groups(cfg)):
        for i, kind in enumerate(group.period):
            pre = f"group{gi}.b{i}."
            shapes.update({pre + k: (group.n,) + v
                           for k, v in _block_shapes(kind, cfg).items()})
    if cfg.mtp:
        shapes["mtp.proj"] = (2 * d, d)
        shapes.update({f"mtp.block.{k}": v
                       for k, v in _block_shapes("attn", cfg).items()})
        shapes.update(_norm_shapes(cfg, "mtp.norm", d))
    return shapes


def param_dtypes(cfg: ArchConfig) -> dict[str, torch.dtype]:
    """The dtype of every parameter `init_params` makes: cfg.dtype, except
    the leaves the reference keeps in float32 (rwkv w0 and u; mamba A_log,
    D and dt_bias; the MoE router)."""
    dtype = getattr(torch, cfg.dtype)
    f32 = tuple(f".rwkv.{name}" for name in rwkv_lib.FLOAT32_LEAVES) \
        + tuple(f".mamba.{name}" for name in ssm_lib.FLOAT32_LEAVES) \
        + tuple(f".moe.{name}" for name in moe_lib.FLOAT32_LEAVES)
    return {path: torch.float32 if path.endswith(f32) else dtype
            for path in param_shapes(cfg)}


def _window(cfg: ArchConfig, kind: BlockKind):
    return cfg.sliding_window if kind == "local" else None


class Extras(NamedTuple):
    """What a block reads besides its own params: the vision embeddings
    (B, vision_seq, D) of a cross block, the top-level shared_attn params
    of a shared_attn block."""
    vision_embeds: Optional[Tensor] = None
    shared_attn: Optional[dict] = None


def shared_attn_params(p: dict, shared: dict) -> dict:
    """The weight-tied attention's params with this invocation's LoRA
    deltas merged into wq and wo, rounded as the reference rounds them:
    w + (a @ b) in w's dtype."""
    sp = dict(shared["attn"])
    sp["wq"] = sp["wq"] + (p["lora_q_a"] @ p["lora_q_b"]).to(sp["wq"].dtype)
    sp["wo"] = sp["wo"] + (p["lora_o_a"] @ p["lora_o_b"]).to(sp["wo"].dtype)
    return sp


def require_vision(extras: Extras, cfg: ArchConfig) -> Tensor:
    if extras.vision_embeds is None:
        raise ValueError(f"{cfg.name}: a cross block needs the vision "
                         "embeddings (B, vision_seq, d_model)")
    return extras.vision_embeds


def attn_flavor(p: dict, x: Tensor, cfg: ArchConfig, kind: BlockKind,
                **cache) -> Tensor:
    """The self-attention of an attention block: MLA where cfg.mla, else
    GQA with the window of a local block; `cache` (return_cache,
    cache_len) as the two take it."""
    if cfg.mla is not None:
        return attn_lib.mla_forward(p, x, cfg, **cache)
    return attn_lib.attn_forward(p, x, cfg, window=_window(cfg, kind),
                                 **cache)


def _zero_aux(x: Tensor) -> Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def apply_block(kind: BlockKind, p: dict, x: Tensor, cfg: ArchConfig,
                extras: Extras = Extras()) -> tuple[Tensor, Tensor]:
    """One pre-norm block: x + attn(norm1 x) (+ the gated cross-attention
    of norm_x x on a cross block), then + ffn(norm2 x) (the MoE FFN on a
    moe block); for rwkv, the time mix and the channel mix in their
    places; for mamba, x + mixer(norm1 x); for shared_attn, the shared
    attention and FFN with this invocation's LoRA and norms.  Returns (x,
    aux): the MoE's Switch aux loss, float32 0 on any other block."""
    h = apply_norm(cfg.norm, p["norm1"], x)
    if kind == "rwkv":
        x = x + rwkv_lib.rwkv_time_mix(p["rwkv"], h, cfg)
        h = apply_norm(cfg.norm, p["norm2"], x)
        return x + rwkv_lib.rwkv_channel_mix(p["rwkv"], h), _zero_aux(x)
    if kind == "mamba":
        return x + ssm_lib.mamba_forward(p["mamba"], h, cfg), _zero_aux(x)
    if kind == "shared_attn":
        x = x + attn_lib.attn_forward(
            shared_attn_params(p, extras.shared_attn), h, cfg)
        h = apply_norm(cfg.norm, p["norm2"], x)
        return (x + apply_ffn(extras.shared_attn["ffn"], h, cfg.activation),
                _zero_aux(x))
    x = x + attn_flavor(p["attn"], h, cfg, kind)
    if kind == "cross":
        h = apply_norm(cfg.norm, p["norm_x"], x)
        x = x + attn_lib.cross_attn_forward(p["xattn"], h,
                                            require_vision(extras, cfg), cfg)
    h = apply_norm(cfg.norm, p["norm2"], x)
    if kind == "moe":
        y, aux = moe_lib.moe_apply(p["moe"], h, cfg)
        return x + y, aux
    return x + apply_ffn(p["ffn"], h, cfg.activation), _zero_aux(x)


def _apply_period(period: tuple[BlockKind, ...], lp: dict, x: Tensor,
                  cfg: ArchConfig, extras: Extras) -> tuple[Tensor, Tensor]:
    aux = _zero_aux(x)
    for i, kind in enumerate(period):
        x, a = apply_block(kind, lp[f"b{i}"], x, cfg, extras)
        aux = aux + a
    return x, aux


def backbone_forward(params: dict, x: Tensor, cfg: ArchConfig,
                     remat: bool = False, extras: Extras = Extras()
                     ) -> tuple[Tensor, Tensor]:
    """Run all scan groups over x (B, S, D), period by period; returns (x,
    the blocks' aux losses summed in layer order).  With `remat` and grad
    on, each period is a `torch.utils.checkpoint` region (non-reentrant):
    only its input is kept, and the backward recomputes it, as the
    reference's `jax.checkpoint` of its scan body does."""
    require_ported(cfg)
    aux = _zero_aux(x)
    for gi, group in enumerate(scan_groups(cfg)):
        for lp in unstack(params[f"group{gi}"], group.n):
            if remat and torch.is_grad_enabled():
                x, a = checkpoint(_apply_period, group.period, lp, x, cfg,
                                  extras, use_reentrant=False)
            else:
                x, a = _apply_period(group.period, lp, x, cfg, extras)
            aux = aux + a
    return x, aux


def embed_tokens(params: dict, tokens: Tensor, cfg: ArchConfig) -> Tensor:
    x = params["embed"][tokens]
    if cfg.tie_embeddings:   # gemma-style scaling, in x's dtype
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def embed_audio(params: dict, features: Tensor, mask: Tensor,
                cfg: ArchConfig) -> Tensor:
    """The audio encoder's input: frame features (B, S, feature_dim) times
    `feat_proj`, with `mask_emb` at the positions where the bool mask
    (B, S) is set (the masked-prediction input)."""
    w = params["feat_proj"]
    x = features.to(w.dtype) @ w
    return torch.where(mask[..., None], params["mask_emb"].to(x.dtype), x)


def embed_inputs(params: dict, inputs: Tensor, cfg: ArchConfig,
                 mask: Optional[Tensor] = None) -> Tensor:
    """The backbone's input: token ids (B, S) through `embed_tokens`; for
    the audio family frame features (B, S, feature_dim) through
    `embed_audio`, with the bool `mask` (B, S), all False (the encoder's
    inference input) when None."""
    if cfg.family != "audio":
        if mask is not None:
            raise ValueError(f"{cfg.name}: a mask is the audio family's "
                             "input")
        return embed_tokens(params, inputs, cfg)
    if inputs.dim() != 3 or inputs.shape[2] != cfg.feature_dim:
        raise ValueError(f"{cfg.name}: frame features of shape "
                         f"{tuple(inputs.shape)}, want (B, S, "
                         f"{cfg.feature_dim})")
    if mask is None:
        mask = torch.zeros(inputs.shape[:2], dtype=torch.bool,
                           device=inputs.device)
    return embed_audio(params, inputs, mask, cfg)


def lm_logits(params: dict, h: Tensor, cfg: ArchConfig) -> Tensor:
    """Final norm, the (tied) unembedding, and the logit softcap in
    float32."""
    h = apply_norm(cfg.norm, params["final_norm"], h)
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = h @ params["unembed"].to(h.dtype)
    return softcap(logits.float(), cfg.logit_softcap)


def cross_entropy(logits: Tensor, targets: Tensor,
                  weights: Tensor | None = None) -> Tensor:
    """Mean CE over weighted positions.  logits float32 (B, S, V)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets.long()[..., None],
                                dim=-1)[..., 0]
    nll = lse - gold
    if weights is None:
        return torch.mean(nll)
    w = weights.float()
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def forward(params, batch: dict, cfg: ArchConfig, remat: bool = True
            ) -> tuple[Tensor, dict]:
    """Training forward of `params` (an `LM` or its tree) on a batch of
    "tokens" and "targets" (B, S), and "vision_embeds" for a vlm; for the
    audio family "features" (B, S, feature_dim) and the bool "mask" (B, S)
    in place of "tokens", the loss then the cross-entropy over the masked
    positions only.  Returns (loss, metrics) with the reference's
    "lm_loss", "aux_loss" (the MoE's, summed over the layers; 0 without
    MoE), "mtp_loss" for an MTP model, and "pooled", the float32 mean over
    the sequence of the backbone's last hidden state (B, D), which the MTL
    probes read.  As the reference's, a MoE model's loss adds
    aux_loss_weight x aux and an MTP model's mtp_weight x mtp_loss."""
    require_ported(cfg, training=torch.is_grad_enabled())
    tree = params.tree() if isinstance(params, ParamTree) else params
    extras = Extras(vision_embeds=batch.get("vision_embeds"),
                    shared_attn=tree.get("shared_attn"))
    audio = cfg.family == "audio"
    x = embed_inputs(tree, batch["features" if audio else "tokens"], cfg,
                     batch["mask"] if audio else None)
    h, aux = backbone_forward(tree, x, cfg, remat=remat, extras=extras)
    lm_loss = cross_entropy(lm_logits(tree, h, cfg), batch["targets"],
                            weights=batch["mask"] if audio else None)
    loss = lm_loss if cfg.moe is None \
        else lm_loss + cfg.moe.aux_loss_weight * aux
    metrics = {"lm_loss": lm_loss, "aux_loss": aux}
    if cfg.mtp and "mtp" in tree:
        mtp_loss = _mtp_loss(tree, h, batch, cfg, extras)
        metrics["mtp_loss"] = mtp_loss
        loss = loss + cfg.mtp_weight * mtp_loss
    metrics["pooled"] = torch.mean(h.float(), dim=1)
    return loss, metrics


def _mtp_loss(params: dict, h: Tensor, batch: dict, cfg: ArchConfig,
              extras: Extras) -> Tensor:
    """DeepSeek's multi-token prediction at depth 1, as the reference's:
    h_t joined with the embedding of token t+1, projected by `mtp.proj`,
    one attention block (`mtp.block`, outside remat), `mtp.norm`, the
    (tied) unembedding and the softcap, against target t+1 (token t+2)."""
    mp = params["mtp"]
    tokens, targets = batch["tokens"], batch["targets"]
    emb_next = embed_tokens(params, tokens[:, 1:], cfg)        # (B, S-1, D)
    hh = torch.cat([h[:, :-1].to(emb_next.dtype), emb_next], dim=-1)
    hh = hh @ mp["proj"].to(hh.dtype)
    hh, _ = apply_block("attn", mp["block"], hh, cfg, extras)
    hh = apply_norm(cfg.norm, mp["norm"], hh)
    if cfg.tie_embeddings:
        logits = hh @ params["embed"].to(hh.dtype).T
    else:
        logits = hh @ params["unembed"].to(hh.dtype)
    return cross_entropy(softcap(logits.float(), cfg.logit_softcap),
                         targets[:, 1:])
