"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

Source: Gemma 3 family, model card hf:google/gemma-3-1b-pt (12B variant).
48 layers = 8 x (5 local + 1 global), d_model 3840, 16 heads (GQA kv=8,
head_dim 256), d_ff 15360, vocab 262 144, sliding window 1024, qk-norm,
GeGLU, tied embeddings.  5:1 sliding-window => long_500k eligible.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    citation="hf:google/gemma-3-1b-pt",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    period=("local",) * 5 + ("global",),
    num_periods=8,
    rope_theta=1000000.0,
    sliding_window=1024,
    local_global_pattern=True,
    qk_norm=True,
    activation="geglu",
    tie_embeddings=True,
    subquadratic=True,
)
