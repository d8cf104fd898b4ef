"""Optimizers, schedules and the proximal wrapper (port of `repro/optim`)."""
from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw, sgdm,
                                          make_optimizer)
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup
from repro_torch.optim.prox_wrapper import proximal_wrap

__all__ = ["Optimizer", "adamw", "adafactor", "sgdm", "make_optimizer",
           "constant", "cosine_warmup", "linear_warmup", "proximal_wrap"]
