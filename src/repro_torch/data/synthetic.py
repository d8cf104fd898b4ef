"""Dataset generators mirroring the paper's experimental workloads (port of
`repro/data/synthetic.py`).

The data are drawn with numpy from the seed exactly as the reference draws
them, so both packages get the same bytes; only the wrap to tensors is the
port's, on an explicit `device`.

* `make_mtl_problem` — random low-rank multi-task regression (paper
  Sec. IV-B.1 synthetic data).
* `make_school_like` — ragged per-task regression shaped like the School
  dataset (139 tasks, 22-251 samples, 28 features; paper Table II).
* `make_mnist_like` — balanced binary classification task packs shaped
  like the paper's 5 MNIST one-vs-one tasks (d=100 after projection).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.core.losses import MTLProblem
from repro_torch.core.simulator import SimProblem


def make_mtl_problem(num_tasks: int = 16, samples: int = 100, dim: int = 64,
                     rank: int = 4, noise: float = 0.1, lam: float = 0.1,
                     reg: str = "nuclear", seed: int = 0,
                     device: torch.device | str | None = None) -> MTLProblem:
    """The reference's problem, as float32 tensors on `device` (CUDA unless
    the caller passes "cpu")."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((dim, rank))
    coef = rng.standard_normal((rank, num_tasks))
    w_true = basis @ coef / np.sqrt(rank)
    xs = rng.standard_normal((num_tasks, samples, dim)) / np.sqrt(dim)
    ys = np.einsum("tnd,dt->tn", xs, w_true)
    ys += noise * rng.standard_normal(ys.shape)
    return MTLProblem(torch.as_tensor(xs.astype(np.float32), device=dev),
                      torch.as_tensor(ys.astype(np.float32), device=dev),
                      "lstsq", reg, lam)


def make_school_like(seed: int = 0) -> SimProblem:
    rng = np.random.default_rng(seed)
    sizes = rng.integers(22, 252, size=139)
    dim = 28
    w_shared = rng.standard_normal(dim)
    xs, ys = [], []
    for n in sizes:
        x = rng.standard_normal((n, dim)) / np.sqrt(dim)
        w_t = w_shared + 0.3 * rng.standard_normal(dim)
        xs.append(x)
        ys.append(x @ w_t + 0.2 * rng.standard_normal(n))
    return SimProblem(xs, ys, "lstsq", "nuclear", 0.1)


def make_mnist_like(num_tasks: int = 5, samples: int = 2000, dim: int = 100,
                    seed: int = 0) -> SimProblem:
    rng = np.random.default_rng(seed)
    w_shared = rng.standard_normal(dim)
    xs, ys = [], []
    for t in range(num_tasks):
        x = rng.standard_normal((samples, dim)) / np.sqrt(dim)
        w_t = w_shared + 0.5 * rng.standard_normal(dim)
        ys.append(np.where(x @ w_t > 0, 1.0, -1.0))
        xs.append(x)
    return SimProblem(xs, ys, "logistic", "nuclear", 0.05)
