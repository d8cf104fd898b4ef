"""LM substrate of the port, for all ten archs of the reference's registry:
dense attention transformers (gemma2-2b, granite-8b, nemotron-4-15b,
gemma3-12b), RWKV-6 (rwkv6-3b), the Mamba-2 hybrid (zamba2-7b), gated
cross-attention (llama-3.2-vision-11b), the audio encoder (hubert-xlarge)
and the MoE archs (dbrx-132b, and deepseek-v3-671b with MLA).  The
exports are the reference's (`repro/models/__init__.py`) but
`ParallelCtx`, which comes with the sharded LM (ROADMAP item 11(i)), and
with the model `LM` that `init_params` returns."""
from repro_torch.models.transformer import (LM, forward, init_params,
                                            scan_groups)
from repro_torch.models.serving import decode_step, init_cache, prefill

__all__ = ["LM", "forward", "init_params", "scan_groups", "decode_step",
           "init_cache", "prefill"]
