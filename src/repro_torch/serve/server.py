"""Learning-while-serving platform over the AMTL session API (port of
`repro/serve/server.py`).

`AMTLServer` holds a long-lived `AMTLEngine` (`core.amtl.make_engine`),
the paper's central server kept learning while task nodes stream events
at it, and splits its two duties onto two CONCURRENT paths:

  * request path — `predict(task_ids, features)` micro-batches incoming
    (task_id, features) rows (at most `max_batch` a slice, padded to a
    power of two) and scores them off the committed serving snapshot.
    The snapshot is read with ONE atomic reference load; the request
    path never takes the learner's state lock, so a prediction never
    waits on an in-flight `run` chunk or the prox refresh inside it.
  * feedback path — `submit_feedback(task_ids, features=None,
    labels=None)` enqueues labeled feedback: an accepted item with
    `(features, labels)` is both one future engine event and one new data
    row for its task.  The chunk runner (the background learner thread
    via `start_learner()`, or the cooperative `step()`) first folds the
    accepted rows into the server's `TaskStore` AT THE CHUNK BOUNDARY,
    then coalesces the queue into ONE engine chunk (a multiple of
    `engine.events_per_step`), advances the session with `engine.run`,
    and flips the serving snapshot at the chunk boundary.

Label-free feedback (`features=None`) never creates a store, and the
problem and engine objects are never rebuilt.  The store is created
lazily (`TaskStore.from_problem`) at the first fold; its initial capacity
is exactly the problem's row budget.

The sharded engine (engine="sharded") serves on a 1-rank mesh
(`launch.mesh.make_task_mesh(1)`, the default outside a
`torch.distributed` world), where its state is the batch engine's; a
mesh of more than one rank raises NotImplementedError (ranks stepping
in lockstep behind one server are ROADMAP.md Queue 1's multi-rank
serving item).

Device and streams.  The server runs on the card unless the caller
passes device="cpu" (`repro_torch.device.resolve_device`; no fallback).
On the card it owns ONE CUDA stream, made in `_configure` after the
caller's current stream (the problem and v0 are ordered before it).
Every piece of engine work of the server goes on that stream: init,
each chunk's fold, `engine.run`, the non-finite guard, `checkpoint()`'s
copies to the host and `resume`'s restore.  `_step_once` enters the
stream itself, so a chunk on the learner thread, on a restarted learner
thread or inline in `step()` is on it (a `torch.cuda.stream` context
holds only in the thread that enters it).  The one-stream rule: the
kernels' scratch assumes one stream at a time on a card
(`kernels/lstsq_grad.py`'s arrival counters are zeroed once a card and
left at zero by each launch), so two servers' chunks must not run at the
same time on one card, and no other engine session may run on another
stream while a server's chunk does.  The request path stays on the
caller's stream: predictions never queue behind a chunk.

Threading model (components in `serve.learner` / `serve.admission`):

  * State lock (`_state_lock`, learner-side only): serializes
    fold -> coalesce -> `engine.run` -> guard -> flip, `checkpoint()`,
    and the cooperative `step()`.  Held for the whole chunk.
  * Queue lock (`_queue_lock`): guards the pending-feedback counters,
    shared by `submit_feedback` (any thread) and the coalescer.  Never
    held across engine work.
  * Atomic flip: the serving snapshot is an immutable `(iterate, event)`
    pair reassigned as ONE reference only after the iterate has finished
    on the server's stream.  In `_step_once` the non-finite guard's
    `bool(isfinite(v).all())` is that synchronization (its one sync a
    chunk); `_install_state` synchronizes the stream.  A reader sees the
    old committed snapshot or the new one, never an in-flight one.
    `predict` marks the snapshot's iterate as used on its own stream
    (`record_stream`), so the allocator never hands the block of a
    snapshot dropped at a later flip to the learner's stream while a
    queued predict still reads it.
  * Lifecycle: `start_learner()` / `stop_learner(drain=...)`; learner
    exceptions are captured and re-raised on stop/join; the
    auto-checkpoint cadence runs on the learner thread unchanged.

Double-buffer equivalence contract (tests/test_torch_serve.py,
tests/test_torch_serve_threaded.py):

  * Zero feedback: the served iterate is BITWISE
    `engine.iterate(engine.init(v0, key))`.
  * With feedback: after any sequence of chunk boundaries (cooperative
    OR on the learner thread) the engine state is BITWISE
    `engine.run(engine.init(v0, key), offs, sum(chunk_log))` over the
    same coalesced chunk sizes, every served snapshot is bitwise some
    chunk-boundary `engine.iterate`, and draining the learner with no
    concurrent submissions reproduces the cooperative `step()` loop's
    chunk log exactly (coalescing is deterministic in the queue).
  * With label-carrying feedback: the engine state is BITWISE the replay
    of the same coalesced chunk log with the same rows folded at the
    same boundaries (fold, rebuild, `engine.run`) over ONE engine
    session; the store at every boundary is bitwise the replayed
    `TaskStore.append` sequence.
  * Restart: `AMTLServer.resume(...)` from a rotated checkpoint is
    invisible to subsequent predictions (pending, not-yet-run feedback is
    the one thing a crash loses).  `checkpoint()` writes the store (when
    one exists) FIRST under `<ckpt_dir>/store/` at the same step, then
    the engine state; resume restores the engine at its newest valid
    step and the store record paired with it.

Latency-SLO-driven admission (`ServeConfig.slo_ms`): the request path
records per-batch predict latency into a `LatencySLOController`, which
deterministically shrinks the admitted chunk budget while the rolling p95
violates the SLO and restores it while the tail is healthy; the trace is
a pure function of the recorded latency sequence (`stats()["slo"]`).
With `slo_shed=True` a degraded controller also sheds NEW feedback.

Per-task admission/QoS (`max_pending_per_task`, `task_chunk_quota`)
bounds what one bursty task can inject: excess queue depth is rejected at
admission, and each chunk consumes at most `task_chunk_quota` events per
task, drained round-robin from a rotating start offset.

Fault tolerance:

  * Supervised learner: with `ServeConfig.restart_limit` set,
    `start_learner()` wraps the thread in a `LearnerSupervisor`: a
    crashed learner auto-restarts under exponential backoff; once the
    budget is spent the circuit breaker latches the server into
    frozen-serving mode (predictions flow, feedback rejected with reason
    "breaker") and the terminal exception surfaces on `stop_learner()`.
  * Non-finite guard: `submit_feedback` rejects rows with non-finite
    features/labels at admission (reason "nonfinite"); `_step_once`
    checks the new iterate with one `isfinite` reduction BEFORE the flip;
    on failure the chunk is discarded, the state stays at the last
    committed one, the rows folded at that boundary are rolled back out
    of the store bitwise, and the coalesced events are quarantined
    (`stats()["health"]`, never re-queued).  The served snapshot never
    goes non-finite, and a poisoned chunk never reaches a checkpoint.
  * Deterministic fault injection: a `serve.faults.FaultPlan` threads
    scripted failure points through this control flow behind a no-op
    default; `resume` bridges torn/corrupt records via
    `checkpoint.latest_valid_step` and drops to older store records on
    `CheckpointCorruptError`.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.checkpoint import CheckpointCorruptError
from repro_torch.core.amtl import AMTLConfig, make_engine
from repro_torch.core.losses import MTLProblem, get_loss
from repro_torch.data.store import TaskStore
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_task_mesh
from repro_torch.serve.admission import make_controller
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.learner import BackgroundLearner, LearnerSupervisor

Tensor = torch.Tensor


class ServeConfig(NamedTuple):
    """Serving-side knobs (the engine itself is configured by AMTLConfig).

    chunk_events         per-chunk event budget: at most this many engine
                         events are coalesced per chunk (must be a
                         positive multiple of `engine.events_per_step`).
                         With an SLO set this is the level-0 budget the
                         admission controller degrades from.
    task_chunk_quota     QoS: max events ONE task contributes to a chunk
                         (None = no per-task cap).  Drained round-robin
                         from a rotating offset.
    max_pending_per_task admission: feedback beyond this per-task queue
                         depth is rejected at `submit_feedback` (None =
                         unbounded queue).
    learning             False freezes the server: feedback is rejected
                         and `step()` is a no-op.
    ckpt_dir             checkpoint directory (None disables checkpoints).
    checkpoint_every     auto-checkpoint after this many learned events
                         (None = only explicit `checkpoint()` calls).
    keep_last            rotation: keep only the k newest `step_*.npz`
                         records (`repro_torch.checkpoint.save`).
    max_batch            predict micro-batch ceiling: larger request
                         batches are served in `max_batch` slices;
                         smaller ones are padded to the next power of two.
    slo_ms               predict-latency SLO in ms (None disables the
                         admission controller and latency recording).
                         When set, `predict` waits for its scores and
                         records the per-batch wall latency.
    slo_window           tumbling-window size (latency samples) between
                         controller decisions.
    slo_shed             True: while the controller is degraded, NEW
                         feedback is shed at admission.  Requires slo_ms.
    restart_limit        number of learner-thread crashes the supervisor
                         auto-restarts through before tripping the circuit
                         breaker.  None (default) = unsupervised learner:
                         a crash parks until surfaced on stop.
    restart_backoff_s    base of the supervisor's exponential restart
                         backoff: crash k waits backoff * 2**k seconds.
    """
    chunk_events: int = 32
    task_chunk_quota: Optional[int] = None
    max_pending_per_task: Optional[int] = None
    learning: bool = True
    ckpt_dir: Optional[str] = None
    checkpoint_every: Optional[int] = None
    keep_last: Optional[int] = None
    max_batch: int = 256
    slo_ms: Optional[float] = None
    slo_window: int = 32
    slo_shed: bool = False
    restart_limit: Optional[int] = None
    restart_backoff_s: float = 0.05


class FeedbackReceipt(tuple):
    """An (accepted, rejected) pair with a `reason` annotation.

    Compares and unpacks as a plain 2-tuple (`receipt == (3, 7)`,
    `a, r = receipt`); `reason` names why rows were rejected — None,
    "frozen", "breaker", "shed", "nonfinite" or "admission".  When one
    call rejects for several reasons the most severe wins (breaker >
    frozen > shed > nonfinite > admission).
    """
    reason: Optional[str]

    def __new__(cls, accepted: int, rejected: int,
                reason: Optional[str] = None):
        self = super().__new__(cls, (int(accepted), int(rejected)))
        self.reason = reason
        return self

    @property
    def accepted(self) -> int:       # enqueued for a future chunk
        return self[0]

    @property
    def rejected(self) -> int:       # capped, shed, frozen, or non-finite
        return self[1]

    def __repr__(self) -> str:
        return (f"FeedbackReceipt(accepted={self[0]}, rejected={self[1]}, "
                f"reason={self.reason!r})")


class ServingSnapshot(NamedTuple):
    """The committed serving state, flipped as one atomic reference: `v`
    is a finished chunk-boundary `engine.iterate`, `event` the engine
    event count it was committed at."""
    v: Tensor
    event: int


def _predict_scores(v: Tensor, task_ids: Tensor, x: Tensor,
                    loss_name: str) -> Tensor:
    """Row scores off the served iterate: the loss's link of x_i·v[:, t_i]."""
    cols = v[:, task_ids].T                       # (B, d)
    return get_loss(loss_name).predict(torch.sum(x * cols, dim=-1))


def _bucket(n: int, cap: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return min(m, cap)


class AMTLServer:
    """A long-lived learning-while-serving AMTL session (see module doc)."""

    def __init__(self, problem: MTLProblem, cfg: AMTLConfig, v0, key,
                 serve_cfg: ServeConfig = ServeConfig(), *,
                 device: torch.device | str | None = None,
                 mesh=None, delay_offsets=None,
                 fault_plan: Optional[FaultPlan] = None):
        self._configure(problem, cfg, serve_cfg, device=device, mesh=mesh,
                        delay_offsets=delay_offsets, fault_plan=fault_plan)
        with self._on_stream():
            state = self.engine.init(v0, key)
        self._install_state(state)

    def _configure(self, problem: MTLProblem, cfg: AMTLConfig,
                   serve_cfg: ServeConfig, *,
                   device: torch.device | str | None = None,
                   mesh=None, delay_offsets=None,
                   fault_plan: Optional[FaultPlan] = None) -> None:
        """Everything construction-time except building/serving a state
        (shared by `__init__` and `resume`)."""
        self.device = resolve_device(device)
        if cfg.engine == "sharded" and mesh is None:
            mesh = make_task_mesh(device=self.device)
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                f"AMTLServer serves the sharded engine on a 1-rank mesh; a "
                f"mesh of {mesh.size} ranks needs ranks stepping in "
                "lockstep behind one server (ROADMAP.md Queue 1, multi-rank "
                "serving after item 9)")
        self.mesh = mesh
        self.problem = problem
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.engine = self._make_engine(problem)
        self._stream = None
        if self.device.type == "cuda":
            # The server's one stream, ordered after the caller's work
            # (the problem and v0 it was handed).
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        per = self.engine.events_per_step
        if serve_cfg.chunk_events < per \
                or serve_cfg.chunk_events % per != 0:
            raise ValueError(
                f"chunk_events ({serve_cfg.chunk_events}) must be a "
                f"positive multiple of the engine's events_per_step "
                f"({per}) so every coalesced chunk is runnable")
        if serve_cfg.task_chunk_quota is not None \
                and serve_cfg.task_chunk_quota < 1:
            raise ValueError(
                f"task_chunk_quota must be >= 1 or None, got "
                f"{serve_cfg.task_chunk_quota}")
        if serve_cfg.max_pending_per_task is not None \
                and serve_cfg.max_pending_per_task < 1:
            raise ValueError(
                f"max_pending_per_task must be >= 1 or None, got "
                f"{serve_cfg.max_pending_per_task}")
        if serve_cfg.checkpoint_every is not None \
                and serve_cfg.ckpt_dir is None:
            raise ValueError("checkpoint_every is set but ckpt_dir is None "
                             "— there is nowhere to write the checkpoints")
        if serve_cfg.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got "
                             f"{serve_cfg.max_batch}")
        if serve_cfg.slo_shed and serve_cfg.slo_ms is None:
            raise ValueError("slo_shed requires slo_ms — there is no "
                             "controller to decide when to shed")
        if serve_cfg.restart_limit is not None \
                and serve_cfg.restart_limit < 0:
            raise ValueError(
                f"restart_limit must be >= 0 or None, got "
                f"{serve_cfg.restart_limit} (None = unsupervised learner)")
        if serve_cfg.restart_backoff_s < 0:
            raise ValueError(f"restart_backoff_s must be >= 0, got "
                             f"{serve_cfg.restart_backoff_s}")
        self._slo = make_controller(serve_cfg.slo_ms, serve_cfg.chunk_events,
                                    per, serve_cfg.slo_window)
        # Fault injection: a no-op plan unless a scripted one is given,
        # so the guarded control flow is identical with and without
        # faults armed (each hook is an integer compare).
        self._faults = fault_plan if fault_plan is not None else FaultPlan()
        self._delay_offsets = delay_offsets
        self._pending = np.zeros(problem.num_tasks, np.int64)
        # Label-carrying feedback: accepted (task_id, x_row, y) rows in
        # arrival order, folded into the store at the next chunk
        # boundary; the store is created lazily at the first fold.
        self._pending_rows: list[tuple[int, np.ndarray, np.float32]] = []
        self._store: Optional[TaskStore] = None
        self._rr = 0                       # rotating round-robin offset
        self.chunk_log: list[int] = []     # coalesced chunk sizes, in order
        # Locks, narrowest-scope first (see module doc threading model):
        # the request path takes NONE of them to read the snapshot.
        self._state_lock = threading.RLock()   # chunk run / checkpoint
        self._queue_lock = threading.Lock()    # pending counters + _rr
        self._stats_lock = threading.Lock()    # request-path counters
        self._learner: Optional[BackgroundLearner | LearnerSupervisor] = None
        self._events_since_ckpt = 0
        self._n_requests = 0
        self._n_predictions = 0
        self._n_rejected = 0
        self._n_shed = 0
        # Fault-tolerance telemetry (stats()["health"]):
        self._breaker_exc: Optional[BaseException] = None
        self._n_breaker_rejected = 0
        self._n_nonfinite_fb = 0       # rows rejected at admission
        self._n_nonfinite_chunks = 0   # chunks discarded by the guard
        self._n_quarantined = 0        # events quarantined by the guard
        self._quarantine_log: list[dict[int, int]] = []  # per-task counts

    def _make_engine(self, problem: MTLProblem):
        """The server's engine on `problem` (the mesh goes along only for
        the sharded engine)."""
        if self.mesh is None:
            return make_engine(problem, self.cfg, self.device)
        return make_engine(problem, self.cfg, self.device, self.mesh)

    def _on_stream(self):
        """The server's stream as the current one in the calling thread
        (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _install_state(self, state) -> None:
        """Serve `state`: wait for its iterate on the server's stream and
        commit the serving snapshot (the only place besides `_step_once`
        that flips it)."""
        self._state = state
        v = self.engine.iterate(state)
        if self._stream is not None:
            self._stream.synchronize()
        self._serving = ServingSnapshot(v, int(state.event))

    # ------------------------------------------------------- request path
    def predict(self, task_ids, features) -> Tensor:
        """Score a micro-batch of (task_id, features) rows.

        Served off the committed snapshot (one atomic reference read) on
        the caller's stream: never blocks on a running chunk or prox
        refresh, never takes the learner's lock.  Batches above
        `max_batch` are served in slices; smaller ones pad to the next
        power of two.  An empty request batch returns an empty (0,)
        float32 tensor.  With an SLO set, the call waits for its scores
        and records the per-batch latency into the admission controller.
        Returns the scores on the server's device.
        """
        t = np.asarray(task_ids, np.int64).reshape(-1)
        x = torch.as_tensor(features, dtype=torch.float32,
                            device=self.device)
        if x.ndim != 2 or x.shape[0] != t.shape[0] \
                or x.shape[1] != self.problem.dim:
            raise ValueError(
                f"features must be (len(task_ids), d) = "
                f"({t.shape[0]}, {self.problem.dim}), got "
                f"{tuple(x.shape)}")
        if t.size and (t.min() < 0 or t.max() >= self.problem.num_tasks):
            raise ValueError(
                f"task_ids must be in [0, {self.problem.num_tasks}), got "
                f"range [{t.min()}, {t.max()}]")
        snap = self._serving                  # ONE atomic reference read
        if self._stream is not None:
            snap.v.record_stream(torch.cuda.current_stream(self.device))
        with self._stats_lock:
            self._n_requests += 1
            self._n_predictions += int(t.shape[0])
        if t.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        t0 = time.perf_counter() if self._slo is not None else 0.0
        cap = self.serve_cfg.max_batch
        outs = []
        for lo in range(0, t.shape[0], cap):
            ts = t[lo:lo + cap]
            xs = x[lo:lo + cap]
            m = _bucket(ts.shape[0], cap)
            pad = m - ts.shape[0]
            if pad:
                ts = np.pad(ts, (0, pad))
                xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
            scores = _predict_scores(
                snap.v, torch.as_tensor(ts, device=self.device), xs,
                self.problem.loss_name)
            outs.append(scores[:m - pad] if pad else scores)
        out = outs[0] if len(outs) == 1 else torch.cat(outs)
        if self._slo is not None:
            if self._stream is not None:      # latency = computed scores
                torch.cuda.current_stream(self.device).synchronize()
            self._slo.record(1e3 * (time.perf_counter() - t0))
        return out

    def iterate(self) -> Tensor:
        """The committed serving iterate (the snapshot's V)."""
        return self._serving.v

    def serving(self) -> ServingSnapshot:
        """The committed `(iterate, event)` snapshot, read atomically."""
        return self._serving

    # ------------------------------------------------------ feedback path
    def submit_feedback(self, task_ids, features=None,
                        labels=None) -> FeedbackReceipt:
        """Enqueue labeled feedback; each accepted item is one future
        engine event.

        `features` (k, d) and `labels` (k,) optionally carry the labeled
        rows (both or neither).  An accepted item with a row is folded
        into the server's `TaskStore` at the next chunk boundary, before
        that chunk runs; a rejected item's row is dropped with its event
        (the receipt's `reason` says why).  A row whose features or label
        are not finite is rejected at admission with its event.
        Label-free items are pure event triggers against the standing
        data.  Thread-safe; wakes a running learner."""
        t = np.asarray(task_ids, np.int64).reshape(-1)
        if t.size and (t.min() < 0 or t.max() >= self.problem.num_tasks):
            raise ValueError(
                f"feedback task_ids must be in "
                f"[0, {self.problem.num_tasks}), got range "
                f"[{t.min()}, {t.max()}]")
        if (features is None) != (labels is None):
            raise ValueError("features and labels must be given together "
                             "(a labeled row is (x, y)) or both omitted")
        rows = None
        if features is not None:
            if self.cfg.engine == "dense":
                raise ValueError(
                    "engine='dense' is the exact uniform baseline and "
                    "cannot grow ragged cohorts; use engine='delta', "
                    "'batch', or 'sharded' for label-carrying feedback")
            x = np.asarray(features, np.float32)
            if x.ndim == 1:
                x = x[None, :]
            y = np.atleast_1d(np.asarray(labels, np.float32))
            if x.shape != (t.size, self.problem.dim) \
                    or y.shape != (t.size,):
                raise ValueError(
                    f"features must be ({t.size}, {self.problem.dim}) and "
                    f"labels ({t.size},) for {t.size} task ids; got "
                    f"{x.shape} and {y.shape}")
            x, y = self._faults.feedback(x, y)  # scripted NaN injection
            rows = (x, y)
        if self._breaker_exc is not None:
            with self._stats_lock:
                self._n_rejected += t.size
                self._n_breaker_rejected += t.size
            return FeedbackReceipt(0, int(t.size), reason="breaker")
        if not self.serve_cfg.learning:
            with self._stats_lock:
                self._n_rejected += t.size
            return FeedbackReceipt(0, int(t.size), reason="frozen")
        if self.serve_cfg.slo_shed and self._slo is not None \
                and self._slo.degraded:
            with self._stats_lock:
                self._n_rejected += t.size
                self._n_shed += t.size
            return FeedbackReceipt(0, int(t.size), reason="shed")
        finite = None
        if rows is not None:
            finite = (np.isfinite(rows[0]).all(axis=1)
                      & np.isfinite(rows[1]))
        cap = self.serve_cfg.max_pending_per_task
        accepted = rejected = nonfinite = 0
        with self._queue_lock:
            for i, ti in enumerate(t):
                if finite is not None and not finite[i]:
                    rejected += 1       # the event dies with its row
                    nonfinite += 1
                elif cap is not None and self._pending[ti] >= cap:
                    rejected += 1
                else:
                    self._pending[ti] += 1
                    if rows is not None:
                        self._pending_rows.append(
                            (int(ti), rows[0][i], rows[1][i]))
                    accepted += 1
        with self._stats_lock:
            self._n_rejected += rejected
            self._n_nonfinite_fb += nonfinite
        if accepted and self._learner is not None and self._learner.running:
            self._learner.wake()
        reason = None
        if nonfinite:
            reason = "nonfinite"
        elif rejected:
            reason = "admission"
        return FeedbackReceipt(accepted, rejected, reason=reason)

    def _coalesce(self) -> np.ndarray:
        """Drain the feedback queue into one runnable chunk.

        Round-robin over tasks from the rotating offset, at most
        `task_chunk_quota` events per task, at most the ADMITTED budget
        (`chunk_events`, degraded by the SLO controller when one is
        configured) total, floored to a multiple of `events_per_step`
        (the floored remainder goes back to the queue, reverse
        consumption order).  Deterministic in the queue contents and the
        admitted budget.  Called with the state lock held.  Returns the
        per-task taken vector.
        """
        per = self.engine.events_per_step
        budget = (self._slo.chunk_events if self._slo is not None
                  else self.serve_cfg.chunk_events)
        quota = self.serve_cfg.task_chunk_quota
        quota = budget if quota is None else quota
        num_tasks = self.problem.num_tasks
        with self._queue_lock:
            order = [(self._rr + i) % num_tasks for i in range(num_tasks)]
            taken = np.zeros(num_tasks, np.int64)
            total = 0
            for ti in order:
                if total >= budget:
                    break
                k = min(int(self._pending[ti]), quota, budget - total)
                if k > 0:
                    taken[ti] = k
                    total += k
            give_back = total - (total // per) * per
            for ti in reversed(order):
                if give_back == 0:
                    break
                k = min(int(taken[ti]), give_back)
                taken[ti] -= k
                give_back -= k
            self._pending -= taken
            if taken.any():
                self._rr = (self._rr + 1) % num_tasks
        return taken

    def _fold_pending_rows(self) -> Optional[tuple]:
        """Publish the accepted labeled rows into the store (chunk
        boundary only; state lock held, on the server's stream).

        Drains `_pending_rows` in arrival order, appends them to the
        store (created lazily from the standing problem at the first
        fold), and rebuilds the published problem and engine against the
        new snapshot (`TaskStore.problem` uploads the whole buffer).  The
        session STATE is untouched (its shapes depend on (d, T, tau),
        never on the row budget), so the next `engine.run` continues the
        same session against more data.

        Returns None when nothing folded, else an undo record
        `(store_undo, prev_problem, prev_engine, created)` the non-finite
        guard uses to unwind the fold bitwise.
        """
        with self._queue_lock:
            rows, self._pending_rows = self._pending_rows, []
        if not rows:
            return None
        created = self._store is None
        if created:
            self._store = TaskStore.from_problem(self.problem)
        tids = np.asarray([r[0] for r in rows], np.int64)
        xs = np.stack([r[1] for r in rows])
        ys = np.asarray([r[2] for r in rows], np.float32)
        prev = (self.problem, self.engine)
        store_undo = self._store.append_undoable(tids, xs, ys)
        self.problem = self._store.problem(self.device)
        self.engine = self._make_engine(self.problem)
        return (store_undo, prev[0], prev[1], created)

    def _unfold_rows(self, fold: Optional[tuple]) -> None:
        """Unwind one `_fold_pending_rows` (state lock held): the store,
        problem, and engine return bitwise to their pre-fold snapshots.
        A store created BY the rolled-back fold is discarded outright."""
        if fold is None:
            return
        store_undo, prev_problem, prev_engine, created = fold
        if created:
            self._store = None
        else:
            self._store.rollback(store_undo)
        self.problem = prev_problem
        self.engine = prev_engine

    def _step_once(self) -> int:
        """One chunk boundary: fold rows -> coalesce -> `engine.run` ->
        non-finite guard -> atomic flip, on the server's stream.

        The guard's `bool(isfinite(v).all())` is the chunk's one host
        synchronization: when it returns, the chunk has finished on the
        stream, so the flip commits a finished iterate.  A non-finite
        result discards the chunk (state, snapshot, and chunk log
        untouched), unwinds the boundary's fold, and quarantines the
        coalesced events.  Auto-checkpoints on the `checkpoint_every`
        cadence.  Runs on the learner thread, or inline via `step()`.

        Returns the events CONSUMED at this boundary (committed or
        quarantined), so drain loops always make progress past a
        poisoned chunk.
        """
        with self._state_lock, self._on_stream():
            fold = self._fold_pending_rows()
            taken = self._coalesce()
            n = int(taken.sum())
            if n == 0:
                return 0
            chunk_idx = self._faults.begin_chunk()
            self._faults.crash_point(chunk_idx)   # scripted learner crash
            state = self.engine.run(self._state, self._delay_offsets, n)
            v = self.engine.iterate(state)
            v = self._faults.poison(chunk_idx, v)  # scripted NaN iterate
            if not bool(torch.isfinite(v).all()):
                # Quarantine: nothing commits.  The last committed
                # snapshot keeps serving, the fold unwinds bitwise, and
                # the chunk's events are logged per task, never
                # re-queued.
                self._unfold_rows(fold)
                with self._stats_lock:
                    self._n_nonfinite_chunks += 1
                    self._n_quarantined += n
                    self._quarantine_log.append(
                        {int(t): int(k) for t, k in enumerate(taken)
                         if k > 0})
                return n
            self._state = state
            self.chunk_log.append(n)
            self._serving = ServingSnapshot(v, int(state.event))  # the flip
            self._events_since_ckpt += n
            every = self.serve_cfg.checkpoint_every
            if every is not None and self._events_since_ckpt >= every:
                self.checkpoint()
            return n

    def step(self) -> int:
        """Cooperative chunk boundary (single-threaded callers).

        Returns the number of events consumed at the boundary (0 if
        frozen, breaker latched, or nothing runnable yet).  While the
        background learner is running, chunks belong to it — call
        `stop_learner()` first.
        """
        if not self.serve_cfg.learning or self._breaker_exc is not None:
            return 0
        if self.learner_running:
            raise RuntimeError(
                "the background learner owns the chunk loop; call "
                "stop_learner() before stepping cooperatively")
        return self._step_once()

    # ------------------------------------------------- learner lifecycle
    @property
    def learner_running(self) -> bool:
        return self._learner is not None and self._learner.running

    @property
    def breaker_tripped(self) -> bool:
        """True once the learner circuit breaker latched the server into
        frozen-serving mode.  Latched for the server's lifetime."""
        return self._breaker_exc is not None

    def _trip_breaker(self, exc: BaseException) -> None:
        """Called by the supervisor when the restart budget is spent."""
        with self._stats_lock:
            self._breaker_exc = exc

    def start_learner(self) -> BackgroundLearner | LearnerSupervisor:
        """Start the background chunk runner (`serve.learner`).  The
        request path keeps serving the committed snapshot throughout;
        `submit_feedback` wakes the thread.  With
        `ServeConfig.restart_limit` set the runner is a
        `LearnerSupervisor`; None keeps the unsupervised
        `BackgroundLearner`."""
        if not self.serve_cfg.learning:
            raise RuntimeError("server is frozen (learning=False); there "
                               "is nothing for a learner thread to run")
        if self._breaker_exc is not None:
            raise RuntimeError(
                "learner circuit breaker is latched (restart budget "
                "exhausted); the server is in frozen-serving mode"
            ) from self._breaker_exc
        if self._learner is None:
            limit = self.serve_cfg.restart_limit
            if limit is None:
                self._learner = BackgroundLearner(self)
            else:
                self._learner = LearnerSupervisor(
                    self, limit=limit,
                    backoff_s=self.serve_cfg.restart_backoff_s)
        self._learner.start()
        return self._learner

    def stop_learner(self, drain: bool = True,
                     timeout: Optional[float] = None) -> int:
        """Stop + join the learner; returns events it learned.  With
        drain=True every runnable chunk is finished first.  Re-raises any
        exception the learner thread died with."""
        if self._learner is None:
            return 0
        return self._learner.stop(drain=drain, timeout=timeout)

    def serve(self, task_ids, features, feedback_task_ids=None,
              feedback_features=None, feedback_labels=None):
        """One request batch: predict, enqueue feedback, run one chunk.

        Predictions are scored against the CURRENT committed snapshot
        before the chunk runs: this batch's feedback affects the NEXT
        batch's predictions.  With the background learner running, the
        chunk step is left to it (ran = 0 here).  Returns (predictions,
        FeedbackReceipt, events_learned).
        """
        preds = self.predict(task_ids, features)
        receipt = FeedbackReceipt(0, 0)
        if feedback_task_ids is not None:
            receipt = self.submit_feedback(feedback_task_ids,
                                           feedback_features,
                                           feedback_labels)
        ran = 0 if self.learner_running else self.step()
        return preds, receipt, ran

    # ------------------------------------------------- checkpoint/restart
    def checkpoint(self) -> Optional[str]:
        """Write the engine state as `step_<event>.npz`, rotated to
        `keep_last`.  Returns the written path (None if no ckpt_dir).
        Serialized against the chunk runner by the state lock; the
        state's copies to the host go on the server's stream.

        When a store exists, its buffers are written FIRST, under
        `<ckpt_dir>/store/` at the SAME step: a crash between the two
        writes leaves an unpaired NEWER store record, which resume
        tolerates, never an engine state whose data is missing.  A
        label-free server writes no store subdir.  The fault plan's
        checkpoint hook sits exactly in that split window."""
        if self.serve_cfg.ckpt_dir is None:
            return None
        with self._state_lock, self._on_stream():
            if self._store is not None:
                self._store.save(
                    os.path.join(self.serve_cfg.ckpt_dir, "store"),
                    int(self._state.event),
                    keep_last=self.serve_cfg.keep_last)
            self._faults.checkpoint_point()  # scripted crash-split
            path = checkpoint.save(self.serve_cfg.ckpt_dir,
                                   int(self._state.event), self._state,
                                   keep_last=self.serve_cfg.keep_last)
            self._events_since_ckpt = 0
        return path

    @classmethod
    def resume(cls, problem: MTLProblem, cfg: AMTLConfig, v0, key,
               serve_cfg: ServeConfig = ServeConfig(), *,
               device: torch.device | str | None = None,
               mesh=None, delay_offsets=None,
               fault_plan: Optional[FaultPlan] = None) -> "AMTLServer":
        """Restart-transparent construction: restore the newest VALID
        rotated checkpoint in `serve_cfg.ckpt_dir` if one exists, else a
        fresh `engine.init(v0, key)` session.  The init state is built
        ONCE (it doubles as `restore`'s `like` layout witness), and only
        the state actually served commits a serving snapshot.

        Record selection is integrity-checked
        (`checkpoint.latest_valid_step`): a torn or bit-rotted newest
        record is skipped and the session falls back one checkpoint
        interval.  A directory whose records are ALL damaged raises
        `CheckpointCorruptError`.

        If the checkpoint has a paired store record, the store is
        restored FIRST and the problem and engine are rebuilt from it. A
        missing or corrupt paired record drops to the remaining store
        records newest-first (the crash-split and bit-rot cases)."""
        server = cls.__new__(cls)
        server._configure(problem, cfg, serve_cfg, device=device, mesh=mesh,
                          delay_offsets=delay_offsets, fault_plan=fault_plan)
        with server._on_stream():
            init_state = server.engine.init(v0, key)
        d = serve_cfg.ckpt_dir
        step = None
        if d is not None:
            step = checkpoint.latest_valid_step(d, like=init_state)
            if step is None and checkpoint.latest_step(d) is not None:
                raise CheckpointCorruptError(
                    d, [], "every engine record in the directory fails "
                    "verification — refusing to silently restart the "
                    "session from scratch")
        if step is None:
            server._install_state(init_state)
            return server
        store_dir = os.path.join(d, "store")

        def _try_store(s: int) -> Optional[TaskStore]:
            try:
                return TaskStore.restore(store_dir, s, problem.loss_name,
                                         problem.reg_name, problem.lam)
            except (FileNotFoundError, CheckpointCorruptError):
                return None

        # Prefer the record paired with the engine step; fall back to
        # the remaining records newest-first (label-free session, a
        # crash between the store and engine writes, or a torn paired
        # record).
        store = _try_store(step)
        if store is None:
            for s in checkpoint.record_steps(store_dir):
                if s == step:
                    continue
                store = _try_store(s)
                if store is not None:
                    break
            if store is None and checkpoint.record_steps(store_dir):
                raise CheckpointCorruptError(
                    store_dir, [], "every store record fails to restore "
                    "— resuming the engine without its folded rows would "
                    "silently change the session")
        with server._on_stream():
            if store is not None:
                server._store = store
                server.problem = store.problem(server.device)
                server.engine = server._make_engine(server.problem)
            state = checkpoint.restore(d, step, like=init_state)
        server._install_state(state)
        return server

    # ---------------------------------------------------------- telemetry
    @property
    def event_count(self) -> int:
        return int(self._state.event)

    @property
    def pending_feedback(self) -> int:
        return int(self._pending.sum())

    @property
    def store_rows(self) -> Optional[int]:
        """Total rows in the store (None until labeled rows fold)."""
        store = self._store
        return None if store is None else store.num_rows

    def stats(self) -> dict[str, Any]:
        sup = (self._learner
               if isinstance(self._learner, LearnerSupervisor) else None)
        health = {
            "learner_restarts": 0 if sup is None else sup.restarts,
            "learner_crashes": 0 if sup is None else sup.crashes,
            "crash_log": [] if sup is None else list(sup.crash_log),
            "recovery_ms": [] if sup is None else list(sup.recovery_ms),
            "breaker_tripped": self.breaker_tripped,
            "breaker_rejected": self._n_breaker_rejected,
            "nonfinite_feedback": self._n_nonfinite_fb,
            "nonfinite_chunks": self._n_nonfinite_chunks,
            "quarantined_feedback": self._n_quarantined,
            "quarantine_log": [dict(q) for q in self._quarantine_log],
        }
        return {
            "requests": self._n_requests,
            "predictions": self._n_predictions,
            "events": self.event_count,
            "chunks": len(self.chunk_log),
            "pending_feedback": self.pending_feedback,
            "pending_rows": len(self._pending_rows),
            "store_rows": self.store_rows,
            "rejected_feedback": self._n_rejected,
            "shed_feedback": self._n_shed,
            "learning": self.serve_cfg.learning,
            "learner_running": self.learner_running,
            "learner_chunks": 0 if self._learner is None
                              else self._learner.chunks,
            "slo": None if self._slo is None else self._slo.snapshot(),
            "health": health,
        }
