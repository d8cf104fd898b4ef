"""Discrete-event simulator for AMTL vs SMTL wall-clock behaviour.

A copy of the reference package's pure-numpy `core/simulator.py`, kept in
the port so that the port never imports the reference package.  It runs
in float64 on the host; the tests hold the port's engines to it.

Reproduces the paper's experimental protocol (Sec. IV): task nodes are kept
idle for `offset + U(0,1)` seconds after each forward step to simulate
network delay; the server serializes proximal mappings.  Unlike the paper's
C++/threads implementation, this is a deterministic discrete-event simulation
— node clocks, stale snapshot reads, and server serialization are explicit —
so Tables I/III/IV-VI and Figs 3-4 are reproducible bit-for-bit under a seed.

The optimization mathematics executed at each event is the *real* AMTL
update (Eq. III.4) on the real data, so objective-vs-iteration curves
(Fig. 4) come out of the same run as the timing.

Supports ragged task sizes and heterogeneous losses (regression +
classification mixed), like the paper's School/MNIST/MTFL setups.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Literal, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Numpy problem container (ragged, heterogeneous)
# ---------------------------------------------------------------------------

def _lstsq_grad(x, y, w):
    return 2.0 * x.T @ (x @ w - y)


def _lstsq_val(x, y, w):
    r = x @ w - y
    return float(r @ r)


def _logistic_grad(x, y, w):
    z = y * (x @ w)
    s = 1.0 / (1.0 + np.exp(np.clip(z, -60, 60)))
    return -(x.T @ (s * y))


def _logistic_val(x, y, w):
    z = y * (x @ w)
    return float(np.sum(np.logaddexp(0.0, -z)))


_NP_LOSSES = {
    "lstsq": (_lstsq_val, _lstsq_grad),
    "logistic": (_logistic_val, _logistic_grad),
}


def _svt(w, t):
    u, s, vt = np.linalg.svd(w, full_matrices=False)
    return (u * np.maximum(s - t, 0.0)) @ vt


def _l21_prox(w, t):
    norms = np.linalg.norm(w, axis=1, keepdims=True)
    return w * np.maximum(0.0, 1.0 - t / np.maximum(norms, 1e-12))


def _nuclear_val(w):
    return float(np.sum(np.linalg.svd(w, compute_uv=False)))


def _l21_val(w):
    return float(np.sum(np.linalg.norm(w, axis=1)))


_NP_REGS = {
    "nuclear": (_nuclear_val, _svt),
    "l21": (_l21_val, _l21_prox),
    "none": (lambda w: 0.0, lambda w, t: w),
}


@dataclass
class SimProblem:
    """Ragged multi-task problem held in host memory."""

    xs: Sequence[np.ndarray]          # T arrays (n_t, d)
    ys: Sequence[np.ndarray]          # T arrays (n_t,)
    losses: Sequence[str]             # per-task loss name (heterogeneous ok)
    reg_name: str = "nuclear"
    lam: float = 0.1

    def __post_init__(self):
        self.xs = [np.asarray(x, np.float64) for x in self.xs]
        self.ys = [np.asarray(y, np.float64) for y in self.ys]
        if isinstance(self.losses, str):
            self.losses = [self.losses] * len(self.xs)

    @property
    def num_tasks(self) -> int:
        return len(self.xs)

    @property
    def dim(self) -> int:
        return self.xs[0].shape[1]

    def task_grad(self, t: int, w_t: np.ndarray) -> np.ndarray:
        return _NP_LOSSES[self.losses[t]][1](self.xs[t], self.ys[t], w_t)

    def prox(self, v: np.ndarray, t: float) -> np.ndarray:
        return _NP_REGS[self.reg_name][1](v, t)

    def objective(self, w: np.ndarray) -> float:
        f = sum(_NP_LOSSES[self.losses[t]][0](self.xs[t], self.ys[t], w[:, t])
                for t in range(self.num_tasks))
        return f + self.lam * _NP_REGS[self.reg_name][0](w)

    def lipschitz(self) -> float:
        out = 0.0
        for t in range(self.num_tasks):
            s = np.linalg.svd(self.xs[t], compute_uv=False)
            smax = s[0] ** 2 if s.size else 1.0
            out = max(out, 2.0 * smax if self.losses[t] == "lstsq"
                      else 0.25 * smax)
        return out


@dataclass
class NetworkModel:
    """Per-cycle node cost: compute + (offset + U[0,1)) network delay.

    Matches the paper's protocol: AMTL-5/10/30 <=> delay_offset 5/10/30 s.
    """

    delay_offset: float = 5.0
    delay_jitter: float = 1.0
    compute_time: float | Sequence[float] = 0.1   # gradient cost per node
    prox_time: float = 0.05                       # server SVT cost

    def node_compute(self, t: int) -> float:
        if np.isscalar(self.compute_time):
            return float(self.compute_time)
        return float(self.compute_time[t])


@dataclass
class SimResult:
    total_time: float
    event_times: list[float] = field(default_factory=list)
    objectives: list[float] = field(default_factory=list)
    w: np.ndarray | None = None
    iterations: int = 0


# ---------------------------------------------------------------------------
# AMTL (asynchronous) event loop
# ---------------------------------------------------------------------------

def simulate_amtl(problem: SimProblem, net: NetworkModel, num_epochs: int,
                  eta: float | None = None, eta_k: float | None = None,
                  tau: int | None = None, dynamic_step: bool = False,
                  delay_window: int = 5, seed: int = 0,
                  record_objective: bool = True,
                  batch_size: int | None = None,
                  prox_every: int = 1) -> SimResult:
    """Event-driven AMTL: each node performs `num_epochs` cycles.

    cycle(t):  snapshot <- server V (stale read at cycle start)
               p = prox(snapshot);  g = grad_t(p_t)        [compute c_t]
               idle for offset + U(0,1)                    [network delay]
               server applies KM write of block t (serialized prox slot)

    batch_size: SGD-AMTL (the paper's §V future work) — each activation
    uses an unbiased (n_t/b)-scaled minibatch gradient and the node's
    compute time shrinks proportionally, so a node completes ~n_t/b more
    asynchronous cycles in the same wall-clock.  `num_epochs` then counts
    minibatch cycles; callers normalize for equal data passes.

    prox_every: server-side prox batching (paper §III-C: "the proximal
    mapping can be also applied after several gradient updates") — the
    server pays `prox_time` only on every K-th write, amortizing the SVT
    when T is large relative to the network delay (the School regime of
    Table III).  Writes between proxes read a cached prox of V.
    """
    rng = np.random.default_rng(seed)
    # separate stream for minibatch sampling: keeps the event/delay
    # sequence identical across batch sizes (including batch == n == full)
    data_rng = np.random.default_rng((seed + 1) * 7919)
    T, d = problem.num_tasks, problem.dim
    lip = problem.lipschitz()
    if eta is None:
        eta = 1.0 / lip
    if tau is None:
        tau = T  # every other node may write once between read and write
    if eta_k is None:
        c = 0.9
        eta_k = c / (2.0 * tau / np.sqrt(T) + 1.0)

    v = np.zeros((d, T))
    delays_hist: list[list[float]] = [[] for _ in range(T)]
    result = SimResult(0.0)

    # Event queue holds (write_time, seq, task, snapshot-at-read).
    # Each node immediately starts its next cycle after its write completes.
    heap: list[tuple[float, int, int, np.ndarray]] = []
    seq = 0
    cycles_left = [num_epochs] * T
    server_free = 0.0

    def compute_cost(t: int) -> float:
        c = net.node_compute(t)
        if batch_size is not None:
            n_t = problem.xs[t].shape[0]
            c *= min(1.0, batch_size / max(n_t, 1))
        return c

    def schedule(t: int, start: float):
        nonlocal seq
        delay = net.delay_offset + net.delay_jitter * rng.random()
        delays_hist[t].append(delay)
        write_time = start + compute_cost(t) + delay
        heapq.heappush(heap, (write_time, seq, t, v.copy()))
        seq += 1

    for t in range(T):
        schedule(t, 0.0)

    events = 0
    cached_prox: np.ndarray | None = None
    while heap:
        write_time, _, t, snapshot = heapq.heappop(heap)
        # Server serializes proximal mappings; with prox_every > 1 the
        # server only pays the SVT on every K-th write (paper §III-C).
        do_prox = (events % prox_every == 0) or cached_prox is None
        start_srv = max(write_time, server_free)
        server_free = start_srv + (net.prox_time if do_prox else 0.0)
        now = server_free

        # Math of Eq. III.4 on the stale snapshot (own block is current).
        snapshot[:, t] = v[:, t]
        if do_prox:
            p = problem.prox(snapshot, eta * problem.lam)
            cached_prox = p
        else:
            p = cached_prox
        if batch_size is None:
            g = problem.task_grad(t, p[:, t])
        else:  # unbiased minibatch gradient (SGD-AMTL)
            n_t = problem.xs[t].shape[0]
            bsz = min(batch_size, n_t)
            idx = data_rng.choice(n_t, size=bsz, replace=False)
            sub_grad = _NP_LOSSES[problem.losses[t]][1](
                problem.xs[t][idx], problem.ys[t][idx], p[:, t])
            g = (n_t / bsz) * sub_grad
        if dynamic_step:
            recent = delays_hist[t][-delay_window:]
            mult = np.log(max(np.mean(recent), 10.0))
        else:
            mult = 1.0
        v[:, t] = v[:, t] + eta_k * mult * (p[:, t] - eta * g - v[:, t])

        events += 1
        if record_objective:
            w = problem.prox(v, eta * problem.lam)
            result.event_times.append(now)
            result.objectives.append(problem.objective(w))

        cycles_left[t] -= 1
        if cycles_left[t] > 0:
            schedule(t, now)
        result.total_time = now

    result.w = problem.prox(v, eta * problem.lam)
    result.iterations = events
    return result


# ---------------------------------------------------------------------------
# SMTL (synchronous) loop
# ---------------------------------------------------------------------------

def simulate_smtl(problem: SimProblem, net: NetworkModel, num_epochs: int,
                  eta: float | None = None, seed: int = 0,
                  record_objective: bool = True) -> SimResult:
    """Synchronous proximal gradient: every round waits for the slowest node.

    round time = max_t (compute_t + delay_t) + prox_time  (paper Sec. III-B)
    """
    rng = np.random.default_rng(seed)
    T, d = problem.num_tasks, problem.dim
    if eta is None:
        eta = 1.0 / problem.lipschitz()

    w = np.zeros((d, T))
    result = SimResult(0.0)
    now = 0.0
    for _ in range(num_epochs):
        round_costs = [net.node_compute(t) + net.delay_offset
                       + net.delay_jitter * rng.random() for t in range(T)]
        now += max(round_costs) + net.prox_time
        grads = np.stack([problem.task_grad(t, w[:, t]) for t in range(T)],
                         axis=1)
        w = problem.prox(w - eta * grads, eta * problem.lam)
        if record_objective:
            result.event_times.append(now)
            result.objectives.append(problem.objective(w))
    result.total_time = now
    result.w = w
    result.iterations = num_epochs
    return result


# ---------------------------------------------------------------------------
# Synthetic data matching the paper's setup (Sec. IV-B.1)
# ---------------------------------------------------------------------------

def make_synthetic(num_tasks: int = 5, samples: int = 100, dim: int = 50,
                   rank: int = 3, noise: float = 0.1,
                   seed: int = 0, loss: str = "lstsq") -> SimProblem:
    """Random low-rank multi-task regression (shared subspace ground truth)."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((dim, rank))
    coef = rng.standard_normal((rank, num_tasks))
    w_true = basis @ coef / np.sqrt(rank)
    xs, ys = [], []
    for t in range(num_tasks):
        x = rng.standard_normal((samples, dim)) / np.sqrt(dim)
        y = x @ w_true[:, t] + noise * rng.standard_normal(samples)
        if loss == "logistic":
            y = np.where(y > 0, 1.0, -1.0)
        xs.append(x)
        ys.append(y)
    return SimProblem(xs, ys, loss, "nuclear", 0.1)
