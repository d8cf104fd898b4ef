"""Per-task loss functions for regularized MTL (port of `core/losses.py`).

Each task t has data (x_t, y_t) and a convex loss: least squares for
regression, logistic for binary classification.  The problem is stacked:
X (T, n, d), Y (T, n), every task with the same n and d.  Iterates are
(d, T), one column per task, as in the reference.

Ragged cohorts (`row_counts`) and the seeded minibatch gradient
(`task_grad_sampled`) belong to the SGD/ragged slice of the port; until
then a problem with `row_counts` set is refused.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class TaskLoss(NamedTuple):
    name: str
    value: Callable[[Tensor, Tensor, Tensor], Tensor]   # (x, y, w) -> scalar
    grad: Callable[[Tensor, Tensor, Tensor], Tensor]    # (x, y, w) -> (d,)
    lipschitz: Callable[[np.ndarray], float]            # (x,) -> L bound
    predict: Callable[[Tensor], Tensor]                 # linear score -> output


# -- least squares: ||x w - y||_2^2, gradient 2 x^T (x w - y) ---------------

def lstsq_value(x: Tensor, y: Tensor, w: Tensor) -> Tensor:
    r = x @ w - y
    return torch.sum(r * r)


def lstsq_grad(x: Tensor, y: Tensor, w: Tensor) -> Tensor:
    return 2.0 * (x.T @ (x @ w - y))


def lstsq_lipschitz(x: np.ndarray) -> float:
    s = np.linalg.svd(np.asarray(x, dtype=np.float64), compute_uv=False)
    return float(2.0 * s[0] ** 2) if s.size else 1.0


def lstsq_predict(score: Tensor) -> Tensor:
    """Regression serves the raw linear score x·w."""
    return score


# -- logistic: sum log(1 + exp(-y x w)), y in {-1, +1} ----------------------

def logistic_value(x: Tensor, y: Tensor, w: Tensor) -> Tensor:
    z = y * (x @ w)
    return torch.sum(torch.logaddexp(torch.zeros_like(z), -z))


def logistic_grad(x: Tensor, y: Tensor, w: Tensor) -> Tensor:
    z = y * (x @ w)
    s = torch.sigmoid(-z)           # = 1 - sigmoid(z)
    return -(x.T @ (s * y))


def logistic_lipschitz(x: np.ndarray) -> float:
    s = np.linalg.svd(np.asarray(x, dtype=np.float64), compute_uv=False)
    return float(0.25 * s[0] ** 2) if s.size else 1.0


def logistic_predict(score: Tensor) -> Tensor:
    """Classification serves P(y = +1) = sigmoid(x·w)."""
    return torch.sigmoid(score)


LOSSES: dict[str, TaskLoss] = {
    "lstsq": TaskLoss("lstsq", lstsq_value, lstsq_grad, lstsq_lipschitz,
                      lstsq_predict),
    "logistic": TaskLoss("logistic", logistic_value, logistic_grad,
                         logistic_lipschitz, logistic_predict),
}


def get_loss(name: str) -> TaskLoss:
    return LOSSES[name]


class MTLProblem(NamedTuple):
    """A stacked multi-task problem: T equal-capacity tasks on one device.

    xs: (T, n, d)  ys: (T, n)  float32 tensors on the device the engine
    runs on.  `row_counts` keeps the reference's field; a problem that
    sets it is refused until the ragged slice is ported.
    """

    xs: Tensor
    ys: Tensor
    loss_name: str
    reg_name: str
    lam: float
    row_counts: Tensor | None = None

    @property
    def num_tasks(self) -> int:
        return self.xs.shape[0]

    @property
    def dim(self) -> int:
        return self.xs.shape[2]

    @property
    def device(self) -> torch.device:
        return self.xs.device

    def _uniform(self) -> None:
        if self.row_counts is not None:
            raise NotImplementedError(
                "ragged problems (row_counts) arrive with the SGD/ragged "
                "slice of the port")

    def loss_value(self, w_cols: Tensor) -> Tensor:
        """f(W) = sum_t ell_t(w_t); w_cols is (d, T)."""
        self._uniform()
        loss = get_loss(self.loss_name)
        return torch.stack([loss.value(self.xs[t], self.ys[t], w_cols[:, t])
                            for t in range(self.num_tasks)]).sum()

    def task_grad(self, t: int, w_t: Tensor) -> Tensor:
        """grad of task t's loss at w_t (a host task index)."""
        self._uniform()
        return get_loss(self.loss_name).grad(self.xs[t], self.ys[t], w_t)

    def full_grad(self, w_cols: Tensor) -> Tensor:
        """nabla f(W) column-stacked, (d, T) — paper Eq. III.2."""
        self._uniform()
        loss = get_loss(self.loss_name)
        return torch.stack([loss.grad(self.xs[t], self.ys[t], w_cols[:, t])
                            for t in range(self.num_tasks)], dim=1)

    def objective(self, w_cols: Tensor) -> Tensor:
        from repro_torch.core.prox import get_regularizer
        reg = get_regularizer(self.reg_name)
        return self.loss_value(w_cols) + self.lam * reg.value(w_cols)

    def lipschitz(self) -> float:
        """max_t L_t — the coordinate-wise Lipschitz bound used for eta."""
        self._uniform()
        loss = get_loss(self.loss_name)
        xs = self.xs.detach().cpu().numpy()
        return max(loss.lipschitz(xs[t]) for t in range(self.num_tasks))
