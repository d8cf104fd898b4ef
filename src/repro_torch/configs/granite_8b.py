"""granite-8b [dense] — llama-arch code model.

Source: Granite Code Models [arXiv:2405.04324] (granite-8b-code).
36 layers, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 49 152,
SwiGLU, RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    citation="arXiv:2405.04324",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    period=("attn",),
    num_periods=36,
    rope_theta=10000000.0,
    activation="swiglu",
)
