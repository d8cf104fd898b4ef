"""Architecture config schema: the port's own copy of the reference's
`configs/base.py` (plain dataclasses, field for field, with the same
`reduced()` and `layer_kinds`), so the port never imports the reference.

Every field that differs between archs is explicit; every config file cites
its source paper/model card.  `reduced()` produces the CPU smoke-test
variant (<=2 layers, d_model<=512, <=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal, Optional, Sequence

BlockKind = Literal[
    "attn",          # full self-attention + dense FFN
    "local",         # sliding-window self-attention + dense FFN
    "global",        # full self-attention + dense FFN (local/global mixes)
    "moe",           # self-attention + MoE FFN
    "mamba",         # Mamba2 SSD block
    "rwkv",          # RWKV6 time-mix + channel-mix
    "shared_attn",   # weight-tied global attention (Zamba2) + LoRA delta
    "cross",         # self-attention + gated cross-attention + FFN (VLM)
]


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    num_shared: int = 0            # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MLACfg:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 64            # N
    head_dim: int = 64             # P
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 128


@dataclass(frozen=True)
class RWKVCfg:
    head_size: int = 64
    decay_lora: int = 64
    chunk: int = 128


@dataclass(frozen=True)
class MTLCfg:
    """The paper's technique attached to the backbone (see DESIGN.md §3)."""
    num_tasks: int = 16
    reg_name: str = "nuclear"
    lam: float = 0.01
    tau: int = 4                   # bounded staleness of the head updates
    activation_rate: float = 0.5   # Bernoulli thinning of Assumption 1
    dynamic_step: bool = True
    eta: float = 0.1
    km_relax: float = 0.9
    probe_weight: float = 0.1      # weight of the probe loss in the backbone


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "audio", "vlm", "hybrid"]
    citation: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer layout: head (unscanned prefix) + period x num_periods + tail
    head_blocks: tuple[BlockKind, ...] = ()
    period: tuple[BlockKind, ...] = ("attn",)
    num_periods: int = 0
    tail_blocks: tuple[BlockKind, ...] = ()

    # attention details
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None       # window for "local" layers
    local_global_pattern: bool = False         # period mixes local/global
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    causal: bool = True                        # False => encoder-only
    qk_norm: bool = False

    activation: Literal["swiglu", "geglu", "relu2", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    tie_embeddings: bool = False

    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    rwkv: Optional[RWKVCfg] = None

    # vlm
    cross_every: int = 0                       # cross-attn layer cadence
    vision_seq: int = 1601                     # stubbed patch embeddings
    # audio
    feature_dim: int = 0                       # stubbed frame-embedding dim
    # deepseek multi-token prediction
    mtp: bool = False
    mtp_weight: float = 0.3

    # serving: KV cache storage ("model" = cfg.dtype, or "int8" for
    # absmax-quantized caches with per-(position, head) f32 scales)
    kv_cache_dtype: str = "model"

    # the paper's technique
    mtl: MTLCfg = field(default_factory=MTLCfg)

    # capability flags for shape selection
    subquadratic: bool = False                 # eligible for long_500k
    has_decode: bool = True                    # False for encoder-only

    dtype: str = "bfloat16"

    def __post_init__(self):
        n_pattern = (len(self.head_blocks) + len(self.period) * self.num_periods
                     + len(self.tail_blocks))
        if n_pattern != self.num_layers:
            raise ValueError(
                f"{self.name}: pattern covers {n_pattern} layers, "
                f"declared num_layers={self.num_layers}")

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/block kinds, tiny dims."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        head_dim = max(32, d_model // n_heads)
        n_kv = min(self.num_kv_heads, n_heads)
        period = self.period
        head = self.head_blocks[:1]
        tail = self.tail_blocks[:1]
        num_periods = 1 if self.num_periods else 0
        num_layers = len(head) + len(period) * num_periods + len(tail)
        changes = dict(
            num_layers=num_layers, d_model=d_model, num_heads=n_heads,
            num_kv_heads=n_kv, head_dim=head_dim, d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_blocks=head, num_periods=num_periods, tail_blocks=tail,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else None,
            dtype="float32",
            mtl=dataclasses.replace(self.mtl, num_tasks=4),
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_expert=128,
                capacity_factor=2.0)
        if self.mla:
            changes["mla"] = MLACfg(q_lora_rank=64, kv_lora_rank=32,
                                    qk_nope_head_dim=32, qk_rope_head_dim=16,
                                    v_head_dim=32)
        if self.ssm:
            changes["ssm"] = dataclasses.replace(self.ssm, state_dim=16,
                                                 head_dim=32, chunk=16)
        if self.rwkv:
            changes["rwkv"] = dataclasses.replace(self.rwkv, head_size=32,
                                                  decay_lora=16, chunk=16)
        if self.feature_dim:
            changes["feature_dim"] = 64
        if self.cross_every:
            changes["vision_seq"] = 16
        return dataclasses.replace(self, **changes)

    @property
    def layer_kinds(self) -> tuple[BlockKind, ...]:
        return (self.head_blocks + self.period * self.num_periods
                + self.tail_blocks)
