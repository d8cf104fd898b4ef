"""gemma2-2b [dense] — alternating local/global attention, logit softcap.

Source: Gemma 2 [arXiv:2408.00118].
26 layers = 13 x (local, global), d_model 2304, 8 heads (GQA kv=4,
head_dim 256), d_ff 9216, vocab 256 000, sliding window 4096,
attention softcap 50, final-logit softcap 30, GeGLU, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    citation="arXiv:2408.00118",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    period=("local", "global"),
    num_periods=13,
    rope_theta=10000.0,
    sliding_window=4096,
    local_global_pattern=True,
    attn_softcap=50.0,
    logit_softcap=30.0,
    activation="geglu",
    tie_embeddings=True,
    subquadratic=True,
)
