"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.

Source: Eagle & Finch [arXiv:2404.05892].
32 layers, d_model 2560 (40 heads of size 64), channel-mix FFN 8960,
vocab 65 536.  Linear-time WKV recurrence => long_500k eligible.
"""
from repro_torch.configs.base import ArchConfig, RWKVCfg

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    citation="arXiv:2404.05892",
    num_layers=32,
    d_model=2560,
    num_heads=40,                    # d_model / head_size
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    period=("rwkv",),
    num_periods=32,
    activation="relu2",              # RWKV channel-mix uses squared ReLU
    norm="layernorm",
    rwkv=RWKVCfg(head_size=64, decay_lora=64),
    subquadratic=True,
)
