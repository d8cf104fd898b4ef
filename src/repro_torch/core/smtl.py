"""Synchronous MTL baselines (paper Sec. III-B), ported from
`repro/core/smtl.py` to PyTorch.

SMTL is synchronized proximal gradient: every iteration takes all T task
gradients, then the server's prox.  FISTA [20] is the accelerated
centralized solver whose optimum anchors convergence checks.  The
reference scans; here each is a plain loop on tensors, and every
iteration's prox is `operators.backward` (with reg_name="l21" the
`l21_prox` kernel on the card).  Like the engines, the solvers run on the
card unless the caller passes device="cpu", and the problem's tensors
must already be there.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.amtl import require_problem_on
from repro_torch.core.losses import MTLProblem
from repro_torch.core.operators import forward_backward
from repro_torch.device import resolve_device

Tensor = torch.Tensor


class SolveResult(NamedTuple):
    w: Tensor              # final model matrix (d, T)
    objectives: Tensor     # objective after each iteration (num_iters,)
    residuals: Tensor      # ||W_{k+1} - W_k||_F per iteration


def _start(problem: MTLProblem, w0, device) -> Tensor:
    dev = resolve_device(device)
    require_problem_on(problem, dev)
    return torch.as_tensor(w0, device=dev).clone()


def _result(w: Tensor, objs: list, ress: list) -> SolveResult:
    def stack(xs):
        return torch.stack(xs) if xs else torch.zeros(
            (0,), dtype=torch.float32, device=w.device)
    return SolveResult(w, stack(objs), stack(ress))


def smtl_solve(problem: MTLProblem, w0, eta: float, num_iters: int,
               device: torch.device | str | None = None) -> SolveResult:
    """Synchronous proximal gradient descent (ISTA form of SMTL)."""
    w = _start(problem, w0, device)
    objs, ress = [], []
    for _ in range(num_iters):
        w_next = forward_backward(problem, w, eta)
        objs.append(problem.objective(w_next))
        ress.append(torch.linalg.vector_norm(w_next - w))
        w = w_next
    return _result(w, objs, ress)


def fista_solve(problem: MTLProblem, w0, eta: float, num_iters: int,
                device: torch.device | str | None = None) -> SolveResult:
    """FISTA [20] — accelerated centralized reference solver.  The
    momentum scalar t is a float32 host number, as the reference carries
    it in w0's dtype."""
    w = _start(problem, w0, device)
    z = w
    t = np.float32(1.0)
    objs, ress = [], []
    for _ in range(num_iters):
        w_next = forward_backward(problem, z, eta)
        t_next = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        z = w_next + float((t - np.float32(1.0)) / t_next) * (w_next - w)
        objs.append(problem.objective(w_next))
        ress.append(torch.linalg.vector_norm(w_next - w))
        w, t = w_next, t_next
    return _result(w, objs, ress)


def reference_optimum(problem: MTLProblem, eta: float | None = None,
                      num_iters: int = 2000,
                      device: torch.device | str | None = None
                      ) -> tuple[Tensor, Tensor]:
    """High-accuracy (W*, obj*) via FISTA from zero, for convergence
    assertions; eta defaults to 1/L."""
    if eta is None:
        eta = 1.0 / problem.lipschitz()
    w0 = torch.zeros((problem.dim, problem.num_tasks), dtype=torch.float32,
                     device=problem.device)
    res = fista_solve(problem, w0, eta, num_iters, device)
    return res.w, res.objectives[-1]
