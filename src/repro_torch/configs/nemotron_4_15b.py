"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP.

Source: Nemotron-4 15B Technical Report [arXiv:2402.16819].
32 layers, d_model 6144, 48 heads (GQA kv=8), d_ff 24576, vocab 256 000,
squared-ReLU activation, RoPE, LayerNorm.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    citation="arXiv:2402.16819",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    period=("attn",),
    num_periods=32,
    rope_theta=10000.0,
    activation="relu2",
    norm="layernorm",
)
