"""hubert-xlarge [audio] — encoder-only masked-cluster prediction.

Source: HuBERT [arXiv:2106.07447] (X-Large: same arch as wav2vec2 XL).
48 layers, d_model 1280, 16 heads (MHA), d_ff 5120, 504 cluster targets.
The conv/mel frontend is a STUB (sanctioned carve-out): input_specs()
provides precomputed frame embeddings (B, S, 1280).
Encoder-only => no decode shapes (DESIGN.md §4); HuBERT's masked
multi-cluster prediction is itself an MTL objective — the natural fit for
the paper's technique.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    citation="arXiv:2106.07447",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    period=("attn",),
    num_periods=48,
    causal=False,
    activation="gelu",
    norm="layernorm",
    feature_dim=1280,
    has_decode=False,
)
