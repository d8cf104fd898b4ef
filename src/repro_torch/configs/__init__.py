"""Architecture registry of the port.

`ARCH_NAMES` lists the reference's ten architectures, `get_config`
returns each and `all_configs` all of them by name; `_PENDING` would name an arch the port cannot serve yet
(get_config raises NotImplementedError for it, naming the ROADMAP item
that brings it), and holds none since dbrx-132b and deepseek-v3-671b came
(item 11(e)).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, MLACfg, MoECfg, MTLCfg,
                                      RWKVCfg, SSMCfg)

_MODULES = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
}

# Archs of the reference that the port does not serve yet, with the item of
# ROADMAP.md (Queue 1, item 11) that brings each.
_PENDING: dict[str, str] = {}

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


def all_configs() -> dict[str, ArchConfig]:
    return {name: get_config(name) for name in ARCH_NAMES}


__all__ = ["ArchConfig", "MoECfg", "MLACfg", "SSMCfg", "RWKVCfg", "MTLCfg",
           "ARCH_NAMES", "SERVED", "get_config", "all_configs"]
