"""AMTL — asynchronous backward-forward coordinate updates (Algorithm 1),
ported from `repro/core/amtl.py` to PyTorch.

Event k activates a task t_k (uniform over tasks), which reads the server
state at staleness nu_k <= tau; the server computes the backward step
prox_{eta*lam*g} on that stale copy, and the node applies the forward step
on its column with KM relaxation eta_k (Eq. III.4), optionally scaled by
the delay-adaptive multiplier (Eq. III.5/III.6).

The reference's four engines are ported:

  engine="dense" — the seed engine: a (tau+1, d, T) ring of full
      iterates.  Event k reads ring[(ptr - nu) % depth] with the task's
      own column taken from the newest slot ring[ptr], runs the exact prox
      on it, and writes the new iterate (the newest one with the task's
      column updated by the `km_update` kernel) into slot ptr + 1.  It is
      the equivalence baseline: the delta engine equals it bitwise at
      prox_every = 1, on the card too (the two column kernels write the
      same fmas).
  engine="delta" (default) — one iterate V (d, T) and a (tau+1, d) undo
      log; the stale read at staleness nu is rebuilt by rolling back the
      nu newest log entries.  Each event's column update and undo-log
      entry is the `amtl_event` kernel.
  engine="batch" — the delta ring, `event_batch` events per loop step,
      the prox refreshed only at batch boundaries (every k-th batch when
      prox_every = k * event_batch, the result carried in a (d, T) cache),
      and the B column updates in one `amtl_event_batch` kernel that
      serializes duplicate tasks in event order.
  engine="sharded" — the batch engine with the T task columns split over
      the ranks of a `torch.distributed` world (`launch.mesh.TaskMesh`,
      one process a rank), T / n_shards columns a rank, each with its own
      (tau+1, d) undo ring and its own tasks' data on its device.  Every
      rank replays the whole serial chain and masks events to their owner
      (`ref.shard_local_tasks`: another rank's event gets the sentinel
      column n_local, which `amtl_event_batch_sharded` drops), so the
      event stream does not depend on the number of ranks.  Collectives
      are paid only at prox refreshes: prox_mode="replicated" gathers the
      (d, T) stale iterate in rank order and runs the batch engine's prox
      on it on every rank; "distributed" (prox_rank required) runs
      `svt_randomized_dist`, a (d, p) sum of partial sketches and a
      (p, n_local) gather of the projected core.  A rank computes the
      gradients of its own events only (one `task_grads` call a step);
      the foreign events' gradient rows are zeros.  At one rank the
      engine is bitwise the batch engine; at n ranks the replicated prox
      gives the batch engine's iterate bitwise, the distributed prox its
      event stream bitwise and its iterate to float32 rounding.

A lstsq full gradient is the `lstsq_grad` kernel: one launch an event
(delta, dense) or a batch step's B gradients in one (batch), every row
with the single event's bits.

With `prox_rank` (nuclear norm only) the refresh is the randomized SVT,
whose sketch and reconstruction are the `gauss_sketch` and
`svt_reconstruct` kernels.  With `batch_size` (SGD-AMTL, paper §V) every
activation's gradient is the (n_t/bsz)-scaled seeded minibatch gradient
(`MTLProblem.task_grad_sampled`: the `lstsq_grad_sampled` kernel for
lstsq, the `sample_mask` kernel's kept rows otherwise); the seed is folded
off the pre-event chain key, so the event stream is unchanged.  Ragged
problems (`row_counts`) run on the delta and batch engines; the dense
engine is the exact uniform baseline and refuses them, and SGD, as in the
reference.  With reg_name="l21" every prox is the `l21_prox` kernel.

Host and device.  The event stream — each event's (task, staleness), the
sketch seeds, the delay history, the per-event eta_k and the minibatch
scalar block (seed, cut_h, cut_i, n_t) — depends only on the PRNG key, the
event counter, `delay_offsets`, the row counts and the config, never on
V; so does which undo-log entry restores which column, and which dense
ring slot each stale read comes from.  `plan_events` replays all of it on
the host (the reference's threefry chain, bit for bit, `core.prng`)
before any device work, and `apply_plan` then issues only V work, with no
device-to-host synchronization per event.  The
state's `task_ring`, `ptr`, `event`, `history` and `key` are host values;
`v`, `delta_ring`, `p_cache` and the dense `ring` are tensors on the
engine's device.

The session API is the reference's:

    engine = make_engine(problem, cfg)                 # device: cuda
    state  = engine.init(v0, key)                      # key: raw uint32[2]
    state  = engine.run(state, delay_offsets, num_events)
    v      = engine.iterate(state)

For engine="sharded", `make_engine(problem, cfg, mesh=mesh)` takes the
global problem (on the host or the rank's device) and keeps only the
rank's block of it on the rank's device (`shard_problem`); `init` takes
the global (d, T) v0, and `iterate` gathers the global (d, T) iterate, a
collective every rank calls.  The state a rank holds is its own view
(`ShardedAMTLState`); `gather_state` and `local_state` convert between
it and the reference's global view, which checkpoints and `interop`
carry.

`run` never mutates the state it is given: it clones `v` and `delta_ring`
(the dense engine: `ring`) once on entry, row-major whatever the
strides it is given, and updates the clones in place, so
`run(s, n + m)` equals `run(run(s, n), m)` bitwise, and `s` stays
valid.  On the CPU (the plain versions of the kernels) the batch
engine equals the delta engine bitwise at a matched prox cadence, as in
the reference.
"""
from __future__ import annotations

import math
import struct
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.dynamic_step import DelayHistory, dynamic_multiplier
from repro_torch.core.losses import MTLProblem
from repro_torch.core.operators import (amtl_max_step, backward,
                                        fixed_point_residual, forward,
                                        restore_columns, rollback_winners)
from repro_torch.core.prox import (ProxPlan, get_regularizer,
                                   svt_randomized, svt_randomized_dist)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (TASK_AXIS, gather_columns,
                                              gather_shards, prox_cache_spec,
                                              sum_partials, task_shard_specs)
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import TaskMesh, make_task_mesh

Tensor = torch.Tensor


class AMTLConfig(NamedTuple):
    eta: float                 # inner forward/backward step, in (0, 2/L)
    eta_k: float               # KM relaxation, <= amtl_max_step(tau, T)
    tau: int                   # max staleness (ring-buffer depth - 1)
    dynamic_step: bool = False
    delay_window: int = 5      # paper averages the last 5 delays
    # The sampled delay is min(round(offset_t + U[0,1) * jitter), tau).
    delay_jitter: float = 1.0
    # "dense", "delta", "batch" or "sharded".
    engine: str = "delta"
    # Server prox amortization (paper §III-C): refresh every K events.
    prox_every: int = 1
    # If set (nuclear reg only), refreshes use the randomized SVT.
    prox_rank: int | None = None
    # engine="batch"/"sharded" only: activations applied per loop step.
    event_batch: int = 1
    # engine="sharded" only: "replicated" or "distributed" server prox.
    prox_mode: str = "replicated"
    # SGD-AMTL minibatch size (paper §V): None = full gradients.
    batch_size: int | None = None


class AMTLState(NamedTuple):
    """Dense-engine state: the seed full-iterate staleness ring."""
    ring: Tensor           # (tau+1, d, T) past iterates, ring[ptr] newest
    ptr: int               # slot of the newest iterate (host)
    event: int             # global event counter (host)
    history: DelayHistory  # per-task recent delays (host)
    key: np.ndarray        # raw uint32[2] PRNG key (host)


class DeltaAMTLState(NamedTuple):
    """Delta-engine state: one iterate + an O(tau*d) undo log."""
    v: Tensor              # (d, T) current iterate (device)
    delta_ring: Tensor     # (tau+1, d) pre-write column per event (device)
    task_ring: np.ndarray  # (tau+1,) int32 task written at each event (host)
    ptr: int               # slot of the newest event (host)
    event: int             # global event counter (host)
    p_cache: Tensor        # (d, T) cached server prox, or a (0, 0) stub
    history: DelayHistory  # per-task recent delays (host)
    key: np.ndarray        # raw uint32[2] PRNG key (host)


class BatchAMTLState(NamedTuple):
    """Batch-engine state: the delta ring with a per-cadence prox cache
    (a (0, 0) stub at the aligned cadence prox_every == event_batch)."""
    v: Tensor
    delta_ring: Tensor
    task_ring: np.ndarray
    ptr: int
    event: int
    p_cache: Tensor
    history: DelayHistory
    key: np.ndarray


class ShardedAMTLState(NamedTuple):
    """Sharded-engine state, one rank's view (engine='sharded').

    The fields are the reference's, in its order and dtypes.  `v` is the
    rank's (d, n_local) block of the reference's column-sharded iterate,
    `delta_ring` its (1, tau+1, d) slice of the reference's (n_shards,
    tau+1, d) rings.  The host fields are replicated: every rank replays
    the whole chain, so each holds the global task ring (global ids), the
    pointer, the counter, the key and the delay history of every task
    (the reference shards the history's rows; their global view is the
    same).  `p_cache` is the replicated prox's (d, T) cache, the
    distributed prox's (d, n_local) block of it when it is carried
    (prox_every > event_batch), or a (0, 0) stub.  `gather_state` gives
    the global view.
    """
    v: Tensor
    delta_ring: Tensor
    task_ring: np.ndarray
    ptr: int
    event: int
    p_cache: Tensor
    history: DelayHistory
    key: np.ndarray


class AMTLResult(NamedTuple):
    v: Tensor              # final auxiliary iterate V (d, T)
    w: Tensor              # final primal W = prox(V) (one extra backward)
    objectives: Tensor     # objective of prox(V) per recorded epoch
    residuals: Tensor      # BF fixed-point residual per recorded epoch


def _prox_cache_init(cfg: AMTLConfig, v0: Tensor) -> Tensor:
    """(d, T) zeros when a cache is carried, else a (0, 0) stub."""
    per_step = cfg.event_batch if cfg.engine in ("batch", "sharded") else 1
    if cfg.prox_every > per_step:
        return torch.zeros_like(v0)
    return torch.zeros((0, 0), dtype=v0.dtype, device=v0.device)


def _init_fields(cfg: AMTLConfig, v0: Tensor, num_tasks: int, key) -> tuple:
    depth = cfg.tau + 1
    return (v0,
            torch.zeros((depth, v0.shape[0]), dtype=v0.dtype,
                        device=v0.device),
            np.zeros((depth,), np.int32), 0, 0,
            _prox_cache_init(cfg, v0),
            DelayHistory.create(num_tasks, cfg.delay_window),
            prng.to_key(prng.to_pair(key)))


def init_state(cfg: AMTLConfig, v0: Tensor, num_tasks: int,
               key) -> AMTLState:
    """Every ring slot a copy of v0."""
    return AMTLState(v0.unsqueeze(0).repeat(cfg.tau + 1, 1, 1), 0, 0,
                     DelayHistory.create(num_tasks, cfg.delay_window),
                     prng.to_key(prng.to_pair(key)))


def init_delta_state(cfg: AMTLConfig, v0: Tensor, num_tasks: int,
                     key) -> DeltaAMTLState:
    return DeltaAMTLState(*_init_fields(cfg, v0, num_tasks, key))


def init_batch_state(cfg: AMTLConfig, v0: Tensor, num_tasks: int,
                     key) -> BatchAMTLState:
    return BatchAMTLState(*_init_fields(cfg, v0, num_tasks, key))


def init_sharded_state(cfg: AMTLConfig, v0: Tensor, num_tasks: int, key,
                       mesh: TaskMesh | None = None) -> ShardedAMTLState:
    """A rank's fresh state from the global (d, T) v0: the rank's view
    (`local_state`) of the global one, v0 with zero undo rings and the
    prox cache."""
    size = 1 if mesh is None else mesh.size
    v0 = v0.clone(memory_format=torch.contiguous_format)
    fields = _init_fields(cfg, v0, num_tasks, key)
    ring = fields[1].unsqueeze(0).repeat(size, 1, 1)     # (n_shards, tau+1, d)
    return local_state(ShardedAMTLState(fields[0], ring, *fields[2:]), cfg,
                       mesh)


# --------------------------------------------------------- event stream ---

def _fma32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """float32 fma(a, b, c) with one rounding (see `kernels.ref._fma32`)."""
    s = float(a) * float(b)                 # exact: 24 + 24 bits < 53
    cc = float(c)
    r = s + cc
    bb = r - s
    err = (s - (r - bb)) + (cc - bb)
    if err != 0 and not struct.unpack("<q", struct.pack("<d", r))[0] & 1:
        r = math.nextafter(r, math.inf if err > 0 else -math.inf)
    return np.float32(r)


def _sample_pair(cfg: AMTLConfig, offsets: np.ndarray, pair, num_tasks: int,
                 event: int):
    """`_sample_activation` on a key pair: (next pair, task, staleness).

    XLA's CPU backend contracts `offset + jitter * u` into one fma, so the
    staleness is rounded from that fma (half to even, as jnp.round).
    """
    nxt, k_task, k_delay = prng.split_pair(pair, 3)
    t = prng.randint_pair(k_task, 0, num_tasks)
    raw = _fma32(np.float32(cfg.delay_jitter), prng.uniform_pair(k_delay),
                 offsets[t])
    nu = min(int(np.rint(raw)), min(cfg.tau, event))
    return nxt, t, nu


def _sample_activation(cfg: AMTLConfig, delay_offsets, key, num_tasks: int,
                       event: int):
    """Shared event sampling: (next key, activated task, staleness nu)."""
    nxt, t, nu = _sample_pair(cfg, np.asarray(delay_offsets, np.float32),
                              prng.to_pair(key), num_tasks, int(event))
    return prng.to_key(nxt), t, nu


def _minibatch_seed(key) -> int:
    """Per-event uint32 sampling seed, folded off the pre-event chain key."""
    return prng.bits_pair(prng.fold_in_pair(prng.to_pair(key), 11))


def _sample_activation_batch(cfg: AMTLConfig, delay_offsets, key,
                             num_tasks: int, event: int, batch: int):
    """`batch` steps of the serial chain: (next key, tasks, stalenesses,
    minibatch seeds), each seed taken off the key the serial engine would
    hold at that event."""
    offs = np.asarray(delay_offsets, np.float32)
    pair = prng.to_pair(key)
    ts, nus, seeds = [], [], []
    for i in range(batch):
        seeds.append(prng.bits_pair(prng.fold_in_pair(pair, 11)))
        pair, t, nu = _sample_pair(cfg, offs, pair, num_tasks, int(event) + i)
        ts.append(t)
        nus.append(nu)
    return (prng.to_key(pair), np.asarray(ts, np.int32),
            np.asarray(nus, np.int32), np.asarray(seeds, np.uint32))


def _eta_k(cfg: AMTLConfig, history: DelayHistory, t: int) -> np.float32:
    if cfg.dynamic_step:
        return np.float32(cfg.eta_k) * dynamic_multiplier(
            history.mean_delay(t))
    return np.float32(cfg.eta_k)


def _km_relaxation(cfg: AMTLConfig, history: DelayHistory, t: int, nu: int):
    """Record the delay and return (updated history, eta_k for this event)."""
    history = history.record(t, nu)
    return history, _eta_k(cfg, history, t)


class EventPlan(NamedTuple):
    """Everything a `run` needs that does not depend on V, for S steps of
    `per_step` events each (N = S * per_step events)."""
    tasks: np.ndarray          # (N,) task of each event
    eta_ks: np.ndarray         # (N,) float32 KM relaxation of each event
    refresh: np.ndarray        # (S,) bool: the step refreshes the prox
    sketch_keys: np.ndarray    # (S, 2) uint32 folded sketch key per step
    rb_cols: np.ndarray        # flat rollback columns of all refreshes
    rb_slots: np.ndarray       # flat rollback ring slots, same order
    rb_offsets: np.ndarray     # (S + 1,) step s owns rb_*[off[s]:off[s+1]]
    ring_slots: np.ndarray     # (S, keep) ring slot of each kept undo entry
    #                            (dense: the slot the new iterate goes to)
    read_slots: np.ndarray     # (S,) dense ring slot of the step's stale read
    scalars: np.ndarray | None  # (N, 4) uint32 minibatch scalar blocks
    #                            (sharded: filled for the rank's events)
    local_tasks: np.ndarray | None  # (N,) batch and sharded: the rank's
    #                            column of each event, n_local for another
    #                            rank's (batch: the task itself)
    task_ring: np.ndarray      # host state after the run
    ptr: int
    event: int
    history: DelayHistory
    key: np.ndarray


def plan_events(problem: MTLProblem, cfg: AMTLConfig, state,
                delay_offsets, num_events: int,
                mesh: TaskMesh | None = None) -> EventPlan:
    """Replay the host side of `num_events` events (no device work).

    For the sharded engine `problem` is the rank's block (`shard_problem`)
    and `mesh` the rank's mesh: the chain runs over the global T tasks,
    the rollbacks restore only the rank's columns, and the minibatch
    blocks are planned for the rank's events only.
    """
    dense = cfg.engine == "dense"
    sharded = cfg.engine == "sharded"
    per_step = cfg.event_batch if cfg.engine in ("batch", "sharded") else 1
    steps = num_events // per_step
    depth = cfg.tau + 1
    keep = min(per_step, depth)
    n_local = problem.num_tasks
    size = mesh.size if sharded and mesh is not None else 1
    t_off = mesh.rank * n_local if size > 1 else 0
    num_tasks = n_local * size
    offs = np.asarray(delay_offsets, np.float32)
    aligned = cfg.prox_every <= per_step
    randomized = cfg.prox_rank is not None and problem.reg_name == "nuclear"

    pair = prng.to_pair(state.key)
    history = state.history.copy()
    # the dense state has no task ring; a scratch one keeps the loop alike
    ring = np.zeros((depth,), np.int32) if dense \
        else np.array(state.task_ring, np.int32)
    ptr, event = int(state.ptr), int(state.event)
    tasks = np.empty((steps * per_step,), np.int64)
    eta_ks = np.empty((steps * per_step,), np.float32)
    refresh = np.zeros((steps,), bool)
    sketch_keys = np.zeros((steps, 2), np.uint32)
    rb_cols, rb_slots, rb_offsets = [], [], [0]
    ring_slots = np.empty((steps, keep), np.int64)
    read_slots = np.empty((steps,), np.int64)
    tail = np.arange(per_step - keep, per_step)
    sgd = cfg.batch_size is not None
    seeds = np.empty((steps * per_step,), np.uint32)
    for s in range(steps):
        first = s * per_step
        refresh[s] = aligned or event % cfg.prox_every == 0
        if refresh[s] and randomized:
            # folded off the step's first pre-event key, as the reference
            sketch_keys[s] = prng.fold_in_pair(pair, 7)
        for i in range(per_step):
            if sgd:
                # folded off the pre-event key, as `_minibatch_seed`
                seeds[first + i] = prng.bits_pair(prng.fold_in_pair(pair, 11))
            pair, t, nu = _sample_pair(cfg, offs, pair, num_tasks, event + i)
            history.record_(t, nu)
            tasks[first + i] = t
            eta_ks[first + i] = _eta_k(cfg, history, t)
            if i == 0:
                nu0 = nu             # the refresh reads at the first staleness
        read_slots[s] = (ptr - nu0) % depth
        if refresh[s] and cfg.tau > 0 and not dense:
            cols, slots = rollback_winners(ring, ptr, nu0, cfg.tau, t_off,
                                           n_local)
            rb_cols.append(cols)
            rb_slots.append(slots)
            rb_offsets.append(rb_offsets[-1] + len(cols))
        else:
            rb_offsets.append(rb_offsets[-1])
        ring_slots[s] = (ptr + 1 + tail) % depth
        ring[ring_slots[s]] = tasks[first + tail]
        ptr = (ptr + per_step) % depth
        event += per_step
    scalars = local = None
    mine = slice(None)
    if cfg.engine in ("batch", "sharded"):
        local, mine = ref.shard_local_tasks(tasks, t_off, n_local)
    if sgd:
        # The row counts cross to the host once per run, never per event.
        ids = tasks[mine] - t_off
        n_ts = None if problem.row_counts is None \
            else problem.host_row_counts()[ids]
        scalars = np.zeros((tasks.shape[0], 4), np.uint32)
        scalars[mine] = ref.sample_scalars(problem.xs.shape[1],
                                           cfg.batch_size, seeds[mine], n_ts)
    empty = np.zeros((0,), np.int64)
    return EventPlan(
        tasks=tasks, eta_ks=eta_ks, refresh=refresh,
        sketch_keys=sketch_keys,
        rb_cols=np.concatenate(rb_cols) if rb_cols else empty,
        rb_slots=np.concatenate(rb_slots) if rb_slots else empty,
        rb_offsets=np.asarray(rb_offsets, np.int64), ring_slots=ring_slots,
        read_slots=read_slots, scalars=scalars, local_tasks=local,
        task_ring=ring, ptr=ptr,
        event=event, history=history, key=prng.to_key(pair))


def _to(device: torch.device, a: np.ndarray, dtype: torch.dtype) -> Tensor:
    return torch.as_tensor(a).to(device=device, dtype=dtype,
                                 non_blocking=True)


def _apply_dense(problem: MTLProblem, cfg: AMTLConfig, state: AMTLState,
                 plan: EventPlan) -> AMTLState:
    """The dense engine's device side (the reference's `_one_event_dense`).

    Per event: the stale read ring[(ptr - nu) % depth] with the task's own
    column from the newest slot, the exact prox, the task's gradient at
    its (contiguous) prox column, and one `ops.km_update_slot`, which
    writes the new iterate into slot ptr + 1: the newest slot with the
    task's column updated (tau = 0 updates its one slot in place).
    `state.ring` is cloned once and the clone updated in place.
    """
    depth = cfg.tau + 1
    ring = state.ring.clone(memory_format=torch.contiguous_format)
    for e in range(plan.tasks.shape[0]):
        t = int(plan.tasks[e])
        new = int(plan.ring_slots[e, 0])
        cur = (new - 1) % depth
        v_hat = ring[int(plan.read_slots[e])].clone()
        v_hat[:, t] = ring[cur, :, t]
        p_t = backward(problem, v_hat, cfg.eta)[:, t].contiguous()
        g_t = problem.task_grad(t, p_t)
        ops.km_update_slot(ring, cur, new, t, p_t, g_t, cfg.eta,
                           float(plan.eta_ks[e]))
    return AMTLState(ring=ring, ptr=plan.ptr, event=plan.event,
                     history=plan.history, key=plan.key)


def _apply_batch(problem: MTLProblem, cfg: AMTLConfig, state,
                 plan: EventPlan, mesh: TaskMesh | None):
    """The batch and sharded engines' device side, `event_batch` events a
    step (the reference's `_one_batch` and `_one_batch_sharded`).

    `problem` is the rank's block, `plan.local_tasks` each event's column
    in it (the sentinel n_local for another rank's event).  The batch
    engine is the one-rank case: `mesh` None, every event owned, its local
    id its task, and every collective the identity.

    A refresh restores the rank's columns from its own ring and patches
    event 0's column on its owner, then either gathers the (d, T) stale
    iterate and runs the prox on it (replicated) or runs
    `svt_randomized_dist` on the block (distributed).  The prox columns of
    the B events are taken by global id (replicated) or by local id,
    another rank's event reading column 0 (distributed).  The rank's own
    events take their gradients in one call; another rank's event keeps a
    zero gradient row.  One `amtl_event_batch_sharded` then runs all B
    events, the others' dropped at the sentinel, and the kept undo rows go
    into the rank's ring, handled as (tau+1, d) whatever the state's
    leading axes.
    """
    dev = state.v.device
    bsz = cfg.event_batch
    steps = plan.refresh.shape[0]
    keep = plan.ring_slots.shape[1]
    n_local = problem.num_tasks
    size = 1 if mesh is None else mesh.size
    t_off = 0 if mesh is None else mesh.rank * n_local
    randomized = cfg.prox_rank is not None and problem.reg_name == "nuclear"
    distributed = cfg.prox_mode == "distributed"
    carried = cfg.prox_every > bsz
    thresh = cfg.eta * problem.lam
    proxplan = ProxPlan(n_local * size, n_local)
    batched = problem.loss_name == "lstsq"

    owned = plan.local_tasks < n_local
    own_events = np.flatnonzero(owned)          # the rank's events, in order
    own_off = np.searchsorted(own_events, np.arange(steps + 1) * bsz)

    v = state.v.clone(memory_format=torch.contiguous_format)
    ring_out = state.delta_ring.clone(memory_format=torch.contiguous_format)
    ring = ring_out.view(-1, ring_out.shape[-1])             # (tau+1, d)
    p_cache = state.p_cache
    rb_cols = _to(dev, plan.rb_cols, torch.int64)
    rb_slots = _to(dev, plan.rb_slots, torch.int64)
    local_dev = _to(dev, plan.local_tasks, torch.int32)
    # the prox columns' index: global ids, or local ids with another
    # rank's event on column 0 (the reference's clamp)
    cols_dev = _to(dev, np.where(owned, plan.local_tasks, 0), torch.int32) \
        if distributed else _to(dev, plan.tasks, torch.int32)
    eta_ks_dev = _to(dev, plan.eta_ks, torch.float32)
    ring_slots_dev = _to(dev, plan.ring_slots, torch.int64)
    own_pos_dev = _to(dev, own_events % bsz, torch.int64)  # within a step
    own_ids_dev = _to(dev, plan.local_tasks[own_events], torch.int32)
    if batched and plan.scalars is not None:
        own_scalars_dev = _to(dev, plan.scalars[own_events], torch.uint32)

    def grads(lo: int, hi: int, p_rows: Tensor) -> Tensor:
        """The rank's events lo:hi (of own_events) at their prox rows; an
        lstsq loss takes them in one call (full or minibatch)."""
        if batched and plan.scalars is None:
            return problem.task_grads(own_ids_dev[lo:hi], p_rows)
        if batched:
            return problem.task_grads_sampled(
                own_ids_dev[lo:hi], p_rows, own_scalars_dev[lo:hi],
                cfg.batch_size)
        g = torch.empty_like(p_rows)
        for i, e in enumerate(own_events[lo:hi]):
            t = int(plan.local_tasks[e])
            g[i] = problem.task_grad(t, p_rows[i]) if plan.scalars is None \
                else problem.task_grad_sampled(t, p_rows[i], plan.scalars[e],
                                               cfg.batch_size)
        return g

    p = p_cache
    for s in range(steps):
        first = s * bsz
        if plan.refresh[s]:
            lo, hi = plan.rb_offsets[s], plan.rb_offsets[s + 1]
            v_hat = restore_columns(v, ring, rb_cols[lo:hi], rb_slots[lo:hi])
            c0 = int(plan.local_tasks[first])
            if c0 < n_local:
                v_hat[:, c0] = v[:, c0]
            if distributed:
                p = svt_randomized_dist(v_hat, thresh, rank=cfg.prox_rank,
                                        key=plan.sketch_keys[s],
                                        plan=proxplan, mesh=mesh)
            else:
                v_hat = gather_columns(v_hat, mesh)
                if randomized:
                    p = svt_randomized(v_hat, thresh, rank=cfg.prox_rank,
                                       key=plan.sketch_keys[s])
                else:
                    p = backward(problem, v_hat, cfg.eta)
            if carried:
                p_cache = p
        p_cols = p.index_select(1, cols_dev[first:first + bsz])   # (d, B)
        lo, hi = int(own_off[s]), int(own_off[s + 1])
        if hi - lo == bsz:
            g_rows = grads(lo, hi, p_cols.T.contiguous())
        else:
            g_rows = torch.zeros((bsz, v.shape[0]), dtype=v.dtype,
                                 device=dev)
            if hi > lo:
                pos = own_pos_dev[lo:hi]
                g_rows.index_copy_(0, pos, grads(
                    lo, hi, p_cols.T.index_select(0, pos).contiguous()))
        _, undo = ops.amtl_event_batch_sharded(
            v, p_cols, g_rows.T.contiguous(), local_dev[first:first + bsz],
            cfg.eta, eta_ks_dev[first:first + bsz])
        ring.index_copy_(0, ring_slots_dev[s], undo[bsz - keep:])
    return type(state)(v=v, delta_ring=ring_out, task_ring=plan.task_ring,
                       ptr=plan.ptr, event=plan.event, p_cache=p_cache,
                       history=plan.history, key=plan.key)


def apply_plan(problem: MTLProblem, cfg: AMTLConfig, state,
               plan: EventPlan, mesh: TaskMesh | None = None):
    """Run the device side of a plan; returns the new state.

    `state.v` and `state.delta_ring` are cloned once, row-major (the
    kernels take contiguous state whatever strides v0 had); the clones are
    updated in place (the delta engine's `ops.amtl_event_inplace`, one
    launch an event; the batch and sharded engines' `_apply_batch`) and
    become the new state's tensors.  The dense engine clones its ring
    instead (`_apply_dense`).
    """
    if cfg.engine == "dense":
        return _apply_dense(problem, cfg, state, plan)
    if cfg.engine in ("batch", "sharded"):
        return _apply_batch(problem, cfg, state, plan, mesh)
    randomized = cfg.prox_rank is not None and problem.reg_name == "nuclear"
    carried = cfg.prox_every > 1
    thresh = cfg.eta * problem.lam
    v = state.v.clone(memory_format=torch.contiguous_format)
    ring = state.delta_ring.clone(memory_format=torch.contiguous_format)
    p_cache = state.p_cache
    rb_cols = _to(v.device, plan.rb_cols, torch.int64)
    rb_slots = _to(v.device, plan.rb_slots, torch.int64)
    p = p_cache
    for e in range(plan.refresh.shape[0]):
        t = int(plan.tasks[e])
        if plan.refresh[e]:
            lo, hi = plan.rb_offsets[e], plan.rb_offsets[e + 1]
            v_hat = restore_columns(v, ring, rb_cols[lo:hi], rb_slots[lo:hi])
            v_hat[:, t] = v[:, t]
            if randomized:
                p = svt_randomized(v_hat, thresh, rank=cfg.prox_rank,
                                   key=plan.sketch_keys[e])
            else:
                p = backward(problem, v_hat, cfg.eta)
            if carried:
                p_cache = p
        p_t = p[:, t].contiguous()
        g_t = problem.task_grad(t, p_t) if plan.scalars is None \
            else problem.task_grad_sampled(t, p_t, plan.scalars[e],
                                           cfg.batch_size)
        ops.amtl_event_inplace(v, t, p_t, g_t, cfg.eta,
                               float(plan.eta_ks[e]), ring,
                               int(plan.ring_slots[e, 0]))
    return DeltaAMTLState(v=v, delta_ring=ring, task_ring=plan.task_ring,
                          ptr=plan.ptr, event=plan.event, p_cache=p_cache,
                          history=plan.history, key=plan.key)


def validate_config(cfg: AMTLConfig, reg_name: str | None = None) -> None:
    """The reference's config validation, check for check."""
    if cfg.engine not in ("delta", "dense", "batch", "sharded"):
        raise ValueError(f"unknown AMTL engine {cfg.engine!r}; "
                         "expected 'delta', 'dense', 'batch', or 'sharded'")
    if cfg.prox_every < 1:
        raise ValueError(f"prox_every must be >= 1, got {cfg.prox_every} "
                         "(1 = exact prox every event)")
    if cfg.event_batch < 1:
        raise ValueError(f"event_batch must be >= 1, got {cfg.event_batch}")
    if cfg.engine in ("dense", "delta") and cfg.event_batch != 1:
        raise ValueError(
            f"engine={cfg.engine!r} processes one event per step; "
            f"event_batch={cfg.event_batch} requires engine='batch' or "
            "engine='sharded'")
    if cfg.prox_rank is not None and reg_name is not None \
            and reg_name != "nuclear":
        raise ValueError(
            "prox_rank selects the randomized SVT refresh, which only "
            f"exists for reg_name='nuclear' (got {reg_name!r})")
    if cfg.engine == "dense" and (cfg.prox_every != 1
                                  or cfg.prox_rank is not None):
        raise ValueError("engine='dense' is the exact seed baseline; "
                         "prox_every>1 / prox_rank require "
                         "engine='delta', 'batch', or 'sharded'")
    if cfg.batch_size is not None:
        if cfg.batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1 (or None for exact full "
                f"gradients), got {cfg.batch_size}")
        if cfg.engine == "dense":
            raise ValueError(
                "engine='dense' is the exact seed baseline and computes "
                "full gradients only; batch_size requires engine='delta', "
                "'batch', or 'sharded'")
    if cfg.engine in ("batch", "sharded") \
            and cfg.prox_every % cfg.event_batch != 0:
        raise ValueError(
            f"engine={cfg.engine!r} refreshes the server prox only at "
            f"batch boundaries, so prox_every ({cfg.prox_every}) must be a "
            f"multiple of event_batch ({cfg.event_batch})")
    if cfg.prox_mode not in ("replicated", "distributed"):
        raise ValueError(f"unknown prox_mode {cfg.prox_mode!r}; "
                         "expected 'replicated' or 'distributed'")
    if cfg.prox_mode == "distributed":
        if cfg.engine != "sharded":
            raise ValueError(
                "prox_mode='distributed' is the sharded engine's "
                "rank-distributed server prox; "
                f"engine={cfg.engine!r} has no shards to distribute over")
        if cfg.prox_rank is None:
            raise ValueError(
                "prox_mode='distributed' distributes the RANDOMIZED SVT "
                "sketch, so prox_rank must be set (the exact dense SVD "
                "has no column-separable decomposition to distribute)")


def _refuse_dense_ragged(problem: MTLProblem, cfg: AMTLConfig) -> None:
    if cfg.engine == "dense" and problem.row_counts is not None:
        raise ValueError(
            "engine='dense' is the exact uniform seed baseline; ragged "
            "problems (row_counts set) require engine='delta', 'batch', "
            "or 'sharded'")


def _resolve_mesh(problem: MTLProblem, cfg: AMTLConfig, mesh,
                  device) -> TaskMesh | None:
    """The reference's checks: a mesh only for engine='sharded', and T
    divisible by its size; the default mesh is every rank of the world
    (one without a world), on `device`."""
    if cfg.engine != "sharded":
        if mesh is not None:
            raise ValueError(
                f"mesh is only meaningful for engine='sharded' "
                f"(got engine={cfg.engine!r})")
        return None
    if mesh is None:
        mesh = make_task_mesh(device=device)
    elif not isinstance(mesh, TaskMesh):
        raise ValueError(f"engine='sharded' needs a {TASK_AXIS!r} TaskMesh "
                         f"(launch.mesh.make_task_mesh); got {mesh!r}")
    elif device is not None and not _same_device(torch.device(device),
                                                 mesh.device):
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.device}")
    mesh.n_local(problem.num_tasks)            # T divisible by the ranks
    return mesh


def _same_device(a: torch.device, b: torch.device) -> bool:
    """a names b (a device without an index names any of its type)."""
    return a.type == b.type and a.index in (None, b.index)


def shard_problem(problem: MTLProblem, mesh: TaskMesh | None) -> MTLProblem:
    """The rank's block of a global problem, on the rank's device: tasks
    [rank * n_local, (rank + 1) * n_local) of xs, ys and row_counts.

    The problem may live on the host (a `TaskStore.problem("cpu")`, say)
    or on the device.  At one rank on the problem's own device it is the
    problem itself; otherwise the block is a copy of its own, so the
    global tensors can be freed.
    """
    if mesh is None or (mesh.size == 1 and problem.device == mesh.device):
        return problem
    n_local = mesh.n_local(problem.num_tasks)
    lo, hi = mesh.rank * n_local, (mesh.rank + 1) * n_local

    def block(x: Tensor | None) -> Tensor | None:
        if x is None:
            return None
        return x[lo:hi].to(mesh.device, copy=True,
                           memory_format=torch.contiguous_format)

    return problem._replace(**{f: block(getattr(problem, f))
                               for f in task_shard_specs()["per_task"]})


def _iterate_metrics(problem: MTLProblem, cfg: AMTLConfig, v: Tensor,
                     mesh: TaskMesh | None = None):
    """(W, objective, BF residual) of the current (d, T) iterate V.

    With a mesh of n > 1 ranks `problem` is the rank's block: each rank
    takes its tasks' losses and residual columns, summed over the ranks
    (a regrouped sum: float32 rounding from the one-process value)."""
    w = backward(problem, v, cfg.eta)
    if mesh is None or mesh.size == 1:
        return (w, problem.objective(w),
                fixed_point_residual(problem, v, cfg.eta))
    lo = mesh.rank * problem.num_tasks
    cols = slice(lo, lo + problem.num_tasks)
    w_loc = w[:, cols]
    loss = sum_partials(problem.loss_value(w_loc).reshape(1), mesh)[0]
    reg = get_regularizer(problem.reg_name)
    res = forward(problem, w_loc, cfg.eta) - v[:, cols]
    sq = sum_partials(torch.sum(res * res).reshape(1), mesh)[0]
    return w, loss + problem.lam * reg.value(w), torch.sqrt(sq)


class AMTLEngine(NamedTuple):
    """A resumable AMTL session (the reference's `AMTLEngine`).

    init(v0, key) -> state
        Fresh state for a (d, T) initial iterate and a raw uint32[2] key.
    run(state, delay_offsets, num_events) -> state
        Advance by `num_events` activations (a multiple of
        `events_per_step`); `delay_offsets` may be None (all zero).
        Composes bitwise and never mutates `state`.
    iterate(state) -> V
        The newest (d, T) iterate held by the state (sharded: gathered
        from the ranks, a collective every rank calls).
    mesh
        The sharded engine's `TaskMesh` (None for the other engines).
    problem
        The problem the engine runs on: the sharded engine's rank block
        (`shard_problem`), else the problem it was given.
    """
    init: Callable[[Any, Any], Any]
    run: Callable[[Any, Any, int], Any]
    iterate: Callable[[Any], Tensor]
    events_per_step: int
    num_tasks: int
    device: torch.device
    mesh: TaskMesh | None = None
    problem: MTLProblem | None = None


def require_problem_on(problem: MTLProblem, dev: torch.device) -> None:
    """Raise unless every tensor of the problem is on `dev`."""
    counts = problem.row_counts
    if problem.xs.device != dev or problem.ys.device != dev or (
            counts is not None and counts.device != dev):
        raise ValueError(f"the problem's tensors are on {problem.xs.device}; "
                         f"the entry point runs on {dev}")


def make_engine(problem: MTLProblem, cfg: AMTLConfig,
                device: torch.device | str | None = None,
                mesh: TaskMesh | None = None) -> AMTLEngine:
    """Build the resumable session engine for `cfg` (the public API).

    `device` defaults to CUDA; without a card this raises unless the
    caller passes device="cpu".  The problem's tensors must already be on
    that device.  Validation runs here, eagerly.

    `mesh` (engine='sharded' only) is the rank's `TaskMesh`; the default
    is every rank of the initialised world, or one rank, on `device`.
    The sharded engine takes the global problem on the host or the rank's
    device and keeps the rank's block of it (`shard_problem`).
    """
    validate_config(cfg, problem.reg_name)
    _refuse_dense_ragged(problem, cfg)
    mesh = _resolve_mesh(problem, cfg, mesh, device)
    dev = resolve_device(device) if mesh is None else mesh.device
    num_tasks = problem.num_tasks
    if mesh is None:
        require_problem_on(problem, dev)
    else:
        problem = shard_problem(problem, mesh)
    per_step = cfg.event_batch if cfg.engine in ("batch", "sharded") else 1
    init_fn = {"dense": init_state, "delta": init_delta_state,
               "batch": init_batch_state}.get(cfg.engine)

    def init(v0, key):
        v0 = torch.as_tensor(v0, dtype=torch.float32, device=dev)
        if mesh is not None:
            return init_sharded_state(cfg, v0, num_tasks, key, mesh)
        v0 = v0.clone(memory_format=torch.contiguous_format)
        return init_fn(cfg, v0, num_tasks, key)

    def run(state, delay_offsets, num_events: int):
        if num_events % per_step != 0:
            raise ValueError(
                f"num_events ({num_events}) must be a multiple of "
                f"event_batch ({per_step}) for engine={cfg.engine!r}")
        on = state.ring.device if isinstance(state, AMTLState) \
            else state.v.device
        if on != dev:
            raise ValueError(f"the state is on {on}; the engine runs on "
                             f"{dev}")
        if delay_offsets is None:
            offs = np.zeros((num_tasks,), np.float32)
        elif isinstance(delay_offsets, torch.Tensor):
            offs = delay_offsets.detach().cpu().numpy().astype(np.float32)
        else:
            offs = np.asarray(delay_offsets, np.float32)
        plan = plan_events(problem, cfg, state, offs, int(num_events), mesh)
        return apply_plan(problem, cfg, state, plan, mesh)

    def iterate(state) -> Tensor:
        return current_iterate(state, mesh)

    return AMTLEngine(init=init, run=run, iterate=iterate,
                      events_per_step=per_step, num_tasks=num_tasks,
                      device=dev, mesh=mesh, problem=problem)


def amtl_solve(problem: MTLProblem, cfg: AMTLConfig, v0, key,
               num_epochs: int, events_per_epoch: int | None = None,
               delay_offsets=None,
               device: torch.device | str | None = None,
               mesh: TaskMesh | None = None) -> AMTLResult:
    """Run AMTL for num_epochs * events_per_epoch activations, with the
    objective and fixed-point residual of prox(V) after each epoch.  One
    epoch defaults to T events.  With the sharded engine the metrics are
    taken on the gathered iterate, every rank's tasks on its rank, and
    every rank returns the same result."""
    engine = make_engine(problem, cfg, device, mesh)
    problem = engine.problem
    if events_per_epoch is None:
        events_per_epoch = engine.num_tasks
    if events_per_epoch % engine.events_per_step != 0:
        raise ValueError(
            f"events_per_epoch ({events_per_epoch}) must be a multiple of "
            f"event_batch ({engine.events_per_step}) for "
            f"engine={cfg.engine!r}")
    state = engine.init(v0, key)
    objs, ress, w = [], [], None
    for _ in range(num_epochs):
        state = engine.run(state, delay_offsets, events_per_epoch)
        w, obj, res = _iterate_metrics(problem, cfg, engine.iterate(state),
                                       engine.mesh)
        objs.append(obj)
        ress.append(res)
    v = engine.iterate(state)
    if w is None:                      # num_epochs == 0
        w = backward(problem, v, cfg.eta)
    empty = torch.zeros((0,), dtype=torch.float32, device=engine.device)
    return AMTLResult(v, w, torch.stack(objs) if objs else empty,
                      torch.stack(ress) if ress else empty)


def amtl_events_only(problem: MTLProblem, cfg: AMTLConfig, v0, key,
                     num_events: int, delay_offsets=None,
                     device: torch.device | str | None = None,
                     mesh: TaskMesh | None = None):
    """Run `num_events` activations with no per-epoch metric tail; returns
    the final engine state (the rank's own, for the sharded engine)."""
    engine = make_engine(problem, cfg, device, mesh)
    return engine.run(engine.init(v0, key), delay_offsets, num_events)


def current_iterate(state, mesh: TaskMesh | None = None) -> Tensor:
    """The newest (d, T) iterate V held by an engine's state; a sharded
    state's columns are gathered over `mesh` (a collective: every rank
    calls it; at one rank, or without a mesh, the state's own v)."""
    if isinstance(state, AMTLState):
        return state.ring[state.ptr]
    if isinstance(state, ShardedAMTLState):
        return gather_columns(state.v, mesh)
    return state.v


def _map_placed(state: ShardedAMTLState, cfg: AMTLConfig,
                columns: Callable[[Tensor], Tensor],
                per_shard: Callable[[Tensor], Tensor]) -> ShardedAMTLState:
    """`state` with each leaf of `task_shard_specs`' columns class (and the
    prox cache, where `prox_cache_spec` places it there) mapped by
    `columns`, and each per_shard leaf by `per_shard`; the replicated
    leaves as they are."""
    specs = task_shard_specs()
    cols = specs["columns"]
    if prox_cache_spec(cfg.prox_mode,
                       cfg.prox_every > cfg.event_batch) == "columns":
        cols += ("p_cache",)
    out = {f: columns(getattr(state, f)) for f in cols}
    out.update({f: per_shard(getattr(state, f)) for f in specs["per_shard"]})
    return state._replace(**out)


def gather_state(state: ShardedAMTLState, cfg: AMTLConfig,
                 mesh: TaskMesh | None) -> ShardedAMTLState:
    """The reference's global view of a sharded state, on every rank: v
    (d, T), delta_ring (n_shards, tau+1, d), p_cache (d, T) or the stub
    (a collective: every rank calls it).  At one rank the state itself."""
    if mesh is None or mesh.size == 1:
        return state
    return _map_placed(state, cfg, lambda x: gather_columns(x, mesh),
                       lambda x: gather_shards(x, mesh))


def global_template(state: ShardedAMTLState, cfg: AMTLConfig,
                    mesh: TaskMesh | None) -> ShardedAMTLState:
    """A state of `gather_state`'s shapes whose sharded leaves are left
    unset (`restore`'s `like`), made with no collective."""
    if mesh is None or mesh.size == 1:
        return state
    n = mesh.size
    return _map_placed(
        state, cfg, lambda x: x.new_empty((x.shape[0], x.shape[1] * n)),
        lambda x: x.new_empty((x.shape[0] * n, *x.shape[1:])))


def local_state(state: ShardedAMTLState, cfg: AMTLConfig,
                mesh: TaskMesh | None) -> ShardedAMTLState:
    """The rank's own view of a global-view sharded state (the inverse of
    `gather_state`): its columns of v (and of a distributed carried
    cache) and its undo ring, each a copy of its own."""
    if mesh is None or mesh.size == 1:
        return state
    n_local = mesh.n_local(state.v.shape[1])
    cols = slice(mesh.rank * n_local, (mesh.rank + 1) * n_local)
    return _map_placed(state, cfg, lambda x: x[:, cols].contiguous(),
                       lambda x: x[mesh.rank:mesh.rank + 1].clone())


def default_config(problem: MTLProblem, tau: int = 4, c: float = 0.9,
                   dynamic_step: bool = False, safety: float = 1.0, *,
                   engine: str = "delta", prox_every: int = 1,
                   prox_rank: int | None = None, event_batch: int = 1,
                   prox_mode: str = "replicated",
                   batch_size: int | None = None) -> AMTLConfig:
    """Step sizes from Theorem 1: eta < 2/L, eta_k <= c/(2 tau/sqrt(T)+1),
    validated like `make_engine` validates."""
    lip = problem.lipschitz()
    cfg = AMTLConfig(
        eta=safety / lip,
        eta_k=amtl_max_step(tau, problem.num_tasks, c),
        tau=tau,
        dynamic_step=dynamic_step,
        engine=engine,
        prox_every=prox_every,
        prox_rank=prox_rank,
        event_batch=event_batch,
        prox_mode=prox_mode,
        batch_size=batch_size,
    )
    validate_config(cfg, problem.reg_name)
    return cfg
