"""Step builders: prefill_step / decode_step.

Port of the serving half of `repro/launch/steps.py`.  The steps take the
model (`models.LM`) and run under `torch.inference_mode()`; the train step
waits for the training slice (ROADMAP.md, Queue 1 item 11).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import serving
from repro_torch.models.transformer import LM


def make_prefill_step(cfg: ArchConfig, s_max: Optional[int] = None):
    def prefill_step(model: LM, tokens: torch.Tensor):
        with torch.inference_mode():
            return serving.prefill(model.tree(), tokens, cfg, s_max=s_max)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode(model: LM, cache: dict, token: torch.Tensor, pos: int):
        with torch.inference_mode():
            return serving.decode_step(model.tree(), cache, token, pos, cfg)
    return decode
