"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

Source: Zamba2 suite [arXiv:2411.15242].
81 layers = 13 x (5 mamba + 1 shared-attn) + 3 mamba, d_model 3584,
shared attention 32 heads (kv=32, head_dim 112) with per-invocation LoRA,
attn-block FFN 14336, Mamba2 state 64, vocab 32 000.
Simplification (DESIGN.md §4): one weight-tied attention block (the real
model alternates two) with rank-64 LoRA deltas per invocation.
Linear-scan backbone => long_500k eligible.
"""
from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    citation="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    period=("mamba",) * 5 + ("shared_attn",),
    num_periods=13,
    tail_blocks=("mamba",) * 3,
    rope_theta=10000.0,
    activation="geglu",
    ssm=SSMCfg(state_dim=64, head_dim=64, expand=2, conv_width=4),
    subquadratic=True,
)
