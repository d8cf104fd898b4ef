"""Architecture registry of the port.

`ARCH_NAMES` lists the reference's ten architectures; `get_config` returns
the ones the port can serve so far and raises NotImplementedError, naming
the ROADMAP item that brings it, for the others.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, MLACfg, MoECfg, MTLCfg,
                                      RWKVCfg, SSMCfg)

_MODULES = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}

# Archs of the reference that the port does not serve yet, with the item of
# ROADMAP.md (Queue 1, item 11) that brings each.
_PENDING = {
    "deepseek-v3-671b": "MLA attention and the MoE FFN",
    "dbrx-132b": "the MoE FFN",
    "nemotron-4-15b": "the relu2 dense path",
    "granite-8b": "the swiglu dense path",
    "gemma3-12b": "the local x5 / global period",
    "zamba2-7b": "the Mamba-2 SSD block and shared attention",
    "llama-3.2-vision-11b": "gated cross-attention",
    "hubert-xlarge": "the audio encoder",
}

ARCH_NAMES = tuple(_MODULES) + tuple(_PENDING)
SERVED = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name in _PENDING:
        raise NotImplementedError(
            f"{name} is not ported yet: it needs {_PENDING[name]} "
            "(ROADMAP.md, Queue 1 item 11)")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_NAMES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


__all__ = ["ArchConfig", "MoECfg", "MLACfg", "SSMCfg", "RWKVCfg", "MTLCfg",
           "ARCH_NAMES", "SERVED", "get_config"]
