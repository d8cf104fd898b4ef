"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.

Source: DeepSeek-V3 Technical Report [arXiv:2412.19437].
61 layers (first 3 dense, 58 MoE), d_model 7168, 128 heads (MLA),
256 routed experts top-8 with d_expert 2048 (the assignment's d_ff=2048),
1 shared expert, vocab 129 280.  Dense-layer FFN is 18432 per the report.
Simplifications (DESIGN.md §4): softmax+aux-loss routing instead of
aux-loss-free bias routing; 1 MTP block.
"""
from repro_torch.configs.base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    citation="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,                      # dense (non-MoE) layers
    vocab_size=129280,
    head_blocks=("attn",) * 3,
    period=("moe",),
    num_periods=58,
    rope_theta=10000.0,
    activation="swiglu",
    moe=MoECfg(num_experts=256, top_k=8, d_expert=2048, num_shared=1),
    mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
               qk_rope_head_dim=64, v_head_dim=128),
    mtp=True,
    subquadratic=False,              # full (MLA) attention
)
