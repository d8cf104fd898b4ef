"""LM substrate of the port: dense attention transformers (gemma2-2b and
the dense archs), RWKV-6 (rwkv6-3b), the Mamba-2 hybrid (zamba2-7b) and
gated cross-attention (llama-3.2-vision-11b)."""
from repro_torch.models.transformer import LM, init_params, scan_groups

__all__ = ["LM", "init_params", "scan_groups"]
