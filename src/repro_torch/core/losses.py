"""Per-task loss functions for regularized MTL (port of `core/losses.py`).

Each task t has data (x_t, y_t) and a convex loss: least squares for
regression, logistic for binary classification.  The problem is stacked:
X (T, n, d), Y (T, n), every task with the same capacity n and d.
Iterates are (d, T), one column per task, as in the reference.

Ragged cohorts: with `row_counts` set, task t owns only its first
row_counts[t] rows, and every loss, gradient and minibatch selection masks
the rest (in the residual or the per-row loss, never in X).  The seeded
minibatch gradient (`task_grad_sampled`) takes the event's host scalar
block (seed, cut_h, cut_i, n_t), planned by `kernels.ref.sample_scalars`.
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
    # ragged variants over a padded row buffer: rows >= n_t (a host int or a
    # 0-d tensor) are masked out of the per-row loss/residual; with n_t == n
    # the all-true mask passes the bits through.
    value_masked: Callable[[Tensor, Tensor, Tensor, Tensor], Tensor]
    grad_masked: Callable[[Tensor, Tensor, Tensor, Tensor], Tensor]


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


def _row_mask(x: Tensor, n_t) -> Tensor:
    """(n,) bool: row index < n_t."""
    return torch.arange(x.shape[0], device=x.device) < n_t


def lstsq_value_masked(x: Tensor, y: Tensor, w: Tensor, n_t) -> Tensor:
    r = torch.where(_row_mask(x, n_t), x @ w - y, 0.0)
    return torch.sum(r * r)


def lstsq_grad_masked(x: Tensor, y: Tensor, w: Tensor, n_t) -> Tensor:
    r = torch.where(_row_mask(x, n_t), x @ w - y, 0.0)
    return 2.0 * (x.T @ r)


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


def logistic_value_masked(x: Tensor, y: Tensor, w: Tensor, n_t) -> Tensor:
    # A zero row is NOT neutral for the logistic value (log 2), so the
    # per-row loss itself is masked, not the data.
    z = y * (x @ w)
    per_row = torch.logaddexp(torch.zeros_like(z), -z)
    return torch.sum(torch.where(_row_mask(x, n_t), per_row, 0.0))


def logistic_grad_masked(x: Tensor, y: Tensor, w: Tensor, n_t) -> Tensor:
    z = y * (x @ w)
    s = torch.sigmoid(-z)
    return -(x.T @ torch.where(_row_mask(x, n_t), s * y, 0.0))


LOSSES: dict[str, TaskLoss] = {
    "lstsq": TaskLoss("lstsq", lstsq_value, lstsq_grad, lstsq_lipschitz,
                      lstsq_predict, lstsq_value_masked, lstsq_grad_masked),
    "logistic": TaskLoss("logistic", logistic_value, logistic_grad,
                         logistic_lipschitz, logistic_predict,
                         logistic_value_masked, logistic_grad_masked),
}


def get_loss(name: str) -> TaskLoss:
    return LOSSES[name]


class MTLProblem(NamedTuple):
    """A stacked multi-task problem: T padded equal-capacity tasks.

    xs: (T, n, d)  ys: (T, n)  float32 tensors on the device the engine
    runs on.  `row_counts` (optional, (T,) int32, on the same device) makes
    the problem ragged: task t owns its first row_counts[t] rows, the rest
    are padding or appended-but-unpublished rows.  None means every row is
    valid.  The masks read row_counts on the device, so no method here
    waits for the card; the engines read it to the host once per `run`.
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

    def to(self, device) -> "MTLProblem":
        """The problem with its tensors on `device` (the same tensors
        where they are there already)."""
        return self._replace(**{
            f: None if getattr(self, f) is None
            else getattr(self, f).to(device)
            for f in ("xs", "ys", "row_counts")})

    def host_row_counts(self) -> np.ndarray:
        """(T,) int64 valid-row counts on the host (n everywhere when the
        problem is uniform).  Reads the device once."""
        if self.row_counts is None:
            return np.full((self.num_tasks,), self.xs.shape[1], np.int64)
        return np.asarray(torch.as_tensor(self.row_counts).cpu(), np.int64)

    def _per_task(self, fn: str, w_cols: Tensor) -> list[Tensor]:
        loss = get_loss(self.loss_name)
        if self.row_counts is None:
            f = getattr(loss, fn)
            return [f(self.xs[t], self.ys[t], w_cols[:, t])
                    for t in range(self.num_tasks)]
        f = getattr(loss, fn + "_masked")
        return [f(self.xs[t], self.ys[t], w_cols[:, t], self.row_counts[t])
                for t in range(self.num_tasks)]

    def loss_value(self, w_cols: Tensor) -> Tensor:
        """f(W) = sum_t ell_t(w_t); w_cols is (d, T)."""
        return torch.stack(self._per_task("value", w_cols)).sum()

    def task_grad(self, t: int, w_t: Tensor) -> Tensor:
        """grad of task t's loss at w_t (a host task index).  lstsq goes to
        `ops.lstsq_grad_task`, which reads the row count on the device (one
        `lstsq_grad` launch on the card, the B = 1 form of `task_grads`;
        on the CPU the composite's bits); other losses take their own
        gradient."""
        from repro_torch.kernels import ops

        if self.loss_name == "lstsq":
            return ops.lstsq_grad_task(self.xs, self.ys, t, w_t,
                                       self.row_counts)
        loss = get_loss(self.loss_name)
        if self.row_counts is None:
            return loss.grad(self.xs[t], self.ys[t], w_t)
        return loss.grad_masked(self.xs[t], self.ys[t], w_t,
                                self.row_counts[t])

    def task_grad_sampled(self, t: int, w_t: Tensor, scalars,
                          batch_size: int) -> Tensor:
        """Unbiased seeded-minibatch gradient of task t's loss at w_t.

        `scalars` is the event's host scalar block (seed, cut_h, cut_i,
        n_t): the minibatch is the exactly-bsz rows (bsz = min(batch_size,
        n_t)) of smallest counter hash, and the gradient is scaled by
        n_t/bsz.  lstsq goes to `ops.lstsq_grad_sampled`; other losses take
        x with its dropped rows zeroed from `ops.sample_rows` (a zero row
        adds nothing to any x^T(...) gradient) and scale the same way.  On
        a CUDA problem both are one kernel launch each.
        """
        from repro_torch.kernels import ops

        x_t, y_t = self.xs[t], self.ys[t]
        if self.loss_name == "lstsq":
            return ops.lstsq_grad_sampled(x_t, w_t, y_t, scalars, batch_size)
        n = x_t.shape[0]
        x_s = ops.sample_rows(x_t, scalars)
        grad = get_loss(self.loss_name).grad(x_s, y_t, w_t)
        if self.row_counts is None:
            return (n / min(batch_size, n)) * grad
        n_t = int(scalars[3])
        bsz = min(batch_size, n_t)
        return float(np.float32(n_t) / np.float32(max(bsz, 1))) * grad

    def task_grads_sampled(self, tasks: Tensor, w_rows: Tensor,
                           scalars: Tensor, batch_size: int) -> Tensor:
        """(B, d) seeded-minibatch gradients of B events of a lstsq problem
        in one call: row e is `task_grad_sampled(tasks[e], w_rows[e],
        scalars[e], batch_size)`, bit for bit.  `tasks` (B,) int32 and
        `scalars` (B, 4) uint32 are tensors on the problem's device (the
        batch engine uploads a plan's blocks once a run); on the card this
        is one launch of the gradient kernel.  The reference computes the
        same B functions one event at a time in its step's scan."""
        from repro_torch.kernels import ops

        if self.loss_name != "lstsq":
            raise ValueError("task_grads_sampled takes lstsq problems; "
                             f"got loss {self.loss_name!r}")
        return ops.lstsq_grad_sampled_batch(self.xs, self.ys, tasks, w_rows,
                                            scalars, batch_size)

    def task_grads(self, tasks: Tensor, w_rows: Tensor) -> Tensor:
        """(B, d) full gradients of B events of a lstsq problem in one
        call: row e is `task_grad(tasks[e], w_rows[e])`, bit for bit.
        `tasks` (B,) int32 is a tensor on the problem's device; on the card
        this is one `lstsq_grad` launch, which reads the tasks and row
        counts there.  The reference computes the same B functions one
        event at a time in its step's scan."""
        from repro_torch.kernels import ops

        if self.loss_name != "lstsq":
            raise ValueError("task_grads takes lstsq problems; got loss "
                             f"{self.loss_name!r}")
        return ops.lstsq_grad_batch(self.xs, self.ys, tasks, w_rows,
                                    self.row_counts)

    def full_grad(self, w_cols: Tensor) -> Tensor:
        """nabla f(W) column-stacked, (d, T) — paper Eq. III.2.  lstsq is
        one `task_grads` call over every task (one launch on the card, as
        the reference's one vmap); other losses loop over the tasks."""
        if self.loss_name == "lstsq":
            tasks = torch.arange(self.num_tasks, dtype=torch.int32,
                                 device=self.device)
            return self.task_grads(tasks, w_cols.T.contiguous()).T
        return torch.stack(self._per_task("grad", w_cols), dim=1)

    def objective(self, w_cols: Tensor) -> Tensor:
        from repro_torch.core.prox import get_regularizer
        reg = get_regularizer(self.reg_name)
        return self.loss_value(w_cols) + self.lam * reg.value(w_cols)

    def lipschitz(self) -> float:
        """max_t L_t — the coordinate-wise Lipschitz bound used for eta,
        over each task's valid rows only."""
        loss = get_loss(self.loss_name)
        xs = self.xs.detach().cpu().numpy()
        counts = self.host_row_counts()
        return max(loss.lipschitz(xs[t][:int(counts[t])])
                   for t in range(self.num_tasks))
