"""LM substrate of the port: dense attention transformers (gemma2-2b) and
RWKV-6 (rwkv6-3b)."""
from repro_torch.models.transformer import LM, init_params, scan_groups

__all__ = ["LM", "init_params", "scan_groups"]
