"""PyTorch/CUDA port of the AMTL system in `repro`.

Imports torch and numpy only.  Entry points run on the CUDA device unless
the caller passes device="cpu", which runs the plain PyTorch versions of
the kernels.
"""
from repro_torch.core import (AMTLConfig, AMTLEngine, MTLProblem,
                              amtl_events_only, amtl_solve, current_iterate,
                              default_config, fista_solve, make_engine,
                              reference_optimum, smtl_solve, validate_config)
from repro_torch.data import TaskStore, stack_ragged
from repro_torch.interop import (problem_from_numpy, state_from_numpy,
                                 state_to_numpy)

__all__ = [
    "AMTLConfig", "AMTLEngine", "MTLProblem", "amtl_events_only",
    "amtl_solve", "current_iterate", "default_config", "make_engine",
    "validate_config", "fista_solve", "reference_optimum", "smtl_solve",
    "problem_from_numpy", "state_from_numpy",
    "state_to_numpy", "TaskStore", "stack_ragged",
]
