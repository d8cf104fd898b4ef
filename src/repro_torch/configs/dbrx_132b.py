"""dbrx-132b [moe] — 16 experts top-4, fine-grained MoE.

Source: model card hf:databricks/dbrx-base.
40 layers, d_model 6144, 48 heads (GQA kv=8), expert FFN 10752,
16 experts top-4, vocab 100 352, GLU activation, RoPE theta 5e5.
"""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    citation="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    period=("moe",),
    num_periods=40,
    rope_theta=500000.0,
    activation="swiglu",
    moe=MoECfg(num_experts=16, top_k=4, d_expert=10752),
)
