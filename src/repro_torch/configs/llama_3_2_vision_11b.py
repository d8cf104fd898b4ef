"""llama-3.2-vision-11b [vlm] — cross-attention image layers.

Source: model card hf:meta-llama/Llama-3.2-11B-Vision.
40 layers, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 128 256;
gated cross-attention every 5th layer (8 of 40).  The ViT vision encoder +
projector are a STUB (sanctioned carve-out): input_specs() provides patch
embeddings (B, 1601, 4096) already projected to d_model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    period=("attn", "attn", "attn", "attn", "cross"),
    num_periods=8,
    rope_theta=500000.0,
    activation="swiglu",
    cross_every=5,
    vision_seq=1601,
)
