"""TaskStore: padded, masked ragged task data with live row ingestion
(port of `repro/data/store.py`).

  * Canonical storage is HOST numpy: `(T, cap, d)` feature and `(T, cap)`
    label buffers plus a `(T,)` int32 `row_counts` vector.  Task t owns
    rows [0, row_counts[t]); rows past its count are zero padding (or
    rows of an undone append); every consumer masks on row_counts.
  * `problem(device)` publishes the buffers as a ragged `MTLProblem` on a
    device: a cached copy, rebuilt only after an append or a rollback, so
    repeated `engine.run` chunks against an unchanged store see the SAME
    tensors and upload nothing.
  * `append` writes labelled rows in arrival order and grows `cap` by
    power-of-two doubling when full, so the number of distinct buffer
    shapes is logarithmic in the final size.  Callers that feed a live
    engine append at chunk boundaries only, and rebuild the engine on the
    new problem; the engine state runs on.
  * `append_undoable`/`rollback` undo one append bitwise, capacity
    included.
  * `save`/`restore` round-trip the buffers through
    `repro_torch.checkpoint` in the reference's record format (keys
    `.xs`, `.ys`, `.row_counts`), so a store record of either package
    restores in the other, bitwise, capacity included.
"""
from __future__ import annotations

import zipfile
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (CheckpointCorruptError,
                                               _resolve_step_path, restore,
                                               save)
from repro_torch.device import resolve_device
from repro_torch.core.losses import MTLProblem


class TaskStoreState(NamedTuple):
    """The store's buffers (host numpy), the reference's checkpoint tree."""
    xs: np.ndarray          # (T, cap, d) float32
    ys: np.ndarray          # (T, cap)    float32
    row_counts: np.ndarray  # (T,)        int32


class StoreUndo(NamedTuple):
    """Inverse of one `append_undoable` call (see `rollback`): the
    pre-append capacity and row_counts and the prior contents of exactly
    the slots the append overwrote."""
    capacity: int
    row_counts: np.ndarray
    slots: list  # [(task, row, prev_x_row, prev_y), ...] for rows < old cap


class TaskStore:
    """Ragged task cohorts over a shared padded buffer; see module doc."""

    def __init__(self, xs, ys, row_counts, loss_name: str, reg_name: str,
                 lam: float, *, copy: bool = True):
        xs = np.asarray(xs, np.float32)
        ys = np.asarray(ys, np.float32)
        row_counts = np.asarray(row_counts, np.int32)
        if xs.ndim != 3 or ys.shape != xs.shape[:2] \
                or row_counts.shape != (xs.shape[0],):
            raise ValueError(
                f"TaskStore buffers must be xs (T, cap, d), ys (T, cap), "
                f"row_counts (T,); got {xs.shape}, {ys.shape}, "
                f"{row_counts.shape}")
        if (row_counts < 0).any() or (row_counts > xs.shape[1]).any():
            raise ValueError(
                f"row_counts must lie in [0, cap={xs.shape[1]}]; "
                f"got {row_counts.tolist()}")
        # copy=False adopts arrays the caller hands over (a record read)
        self._xs = xs.copy() if copy else xs
        self._ys = ys.copy() if copy else ys
        self._row_counts = row_counts.copy()
        self._loss_name = loss_name
        self._reg_name = reg_name
        self._lam = float(lam)
        self._problems: dict[torch.device, MTLProblem] = {}

    # ------------------------------------------------------ constructors --

    @classmethod
    def from_problem(cls, problem: MTLProblem) -> "TaskStore":
        """Adopt a problem's buffers; capacity is exactly the problem's n.
        A device problem's host copies are adopted as they are; a host
        problem's tensors are copied."""
        on_host = problem.xs.device.type == "cpu"
        return cls(problem.xs.detach().cpu().numpy(),
                   problem.ys.detach().cpu().numpy(),
                   problem.host_row_counts(), problem.loss_name,
                   problem.reg_name, problem.lam, copy=on_host)

    @classmethod
    def from_ragged(cls, xs_list: Sequence, ys_list: Sequence,
                    loss_name: str, reg_name: str, lam: float) -> "TaskStore":
        """Pad a list of per-task (x_t (n_t, d), y_t (n_t,)) cohorts;
        capacity = max_t n_t."""
        if len(xs_list) != len(ys_list) or not xs_list:
            raise ValueError("need equal, non-empty xs/ys cohort lists")
        d = np.asarray(xs_list[0]).shape[1]
        counts = np.asarray([len(x) for x in xs_list], np.int32)
        cap = int(counts.max())
        t = len(xs_list)
        xs = np.zeros((t, cap, d), np.float32)
        ys = np.zeros((t, cap), np.float32)
        for i, (x, y) in enumerate(zip(xs_list, ys_list)):
            x = np.asarray(x, np.float32)
            y = np.asarray(y, np.float32)
            if x.shape != (counts[i], d) or y.shape != (counts[i],):
                raise ValueError(
                    f"cohort {i}: expected x ({counts[i]}, {d}) and "
                    f"y ({counts[i]},), got {x.shape} and {y.shape}")
            xs[i, :counts[i]] = x
            ys[i, :counts[i]] = y
        return cls(xs, ys, counts, loss_name, reg_name, lam)

    # -------------------------------------------------------- properties --

    @property
    def num_tasks(self) -> int:
        return self._xs.shape[0]

    @property
    def capacity(self) -> int:
        return self._xs.shape[1]

    @property
    def dim(self) -> int:
        return self._xs.shape[2]

    @property
    def row_counts(self) -> np.ndarray:
        return self._row_counts.copy()

    @property
    def num_rows(self) -> int:
        """Total valid rows across tasks."""
        return int(self._row_counts.sum())

    # ----------------------------------------------------- problem view ---

    def problem(self, device: torch.device | str | None = None) -> MTLProblem:
        """The store's current snapshot as a ragged MTLProblem on `device`
        (CUDA unless the caller passes "cpu").

        Cached per device: repeated calls between appends return the SAME
        tensors.  The tensors are copies, so a later append never changes
        a problem already handed out.
        """
        dev = resolve_device(device)
        if dev not in self._problems:
            self._problems[dev] = MTLProblem(
                torch.tensor(self._xs, device=dev),
                torch.tensor(self._ys, device=dev),
                self._loss_name, self._reg_name, self._lam,
                torch.tensor(self._row_counts, device=dev))
        return self._problems[dev]

    # ---------------------------------------------------------- appends ---

    def append(self, task_ids, features, labels,
               capacity: int | None = None) -> int:
        """Append labelled rows (one per task id) in arrival order.

        task_ids (k,) int, features (k, d) float, labels (k,) float.  Rows
        land at each task's current row count; capacity doubles (all tasks
        share one capacity) until every row fits, and until `capacity`
        rows fit where it is given (a store that holds some tasks of a
        larger one grows with the whole: `serve.lockstep`).  Returns k.
        """
        task_ids = np.atleast_1d(np.asarray(task_ids, np.int64))
        features = np.asarray(features, np.float32)
        labels = np.atleast_1d(np.asarray(labels, np.float32))
        if features.ndim == 1:
            features = features[None, :]
        k = task_ids.shape[0]
        if features.shape != (k, self.dim) or labels.shape != (k,):
            raise ValueError(
                f"append expects features ({k}, {self.dim}) and labels "
                f"({k},) for {k} task ids; got {features.shape} and "
                f"{labels.shape}")
        if (task_ids < 0).any() or (task_ids >= self.num_tasks).any():
            raise ValueError(
                f"task_ids must lie in [0, {self.num_tasks}); "
                f"got {np.unique(task_ids).tolist()}")
        final = self._row_counts.copy()
        np.add.at(final, task_ids, 1)
        need = max(int(final.max()), capacity or 0)
        if need > self.capacity:
            self._grow(need)
            self._problems.clear()
        if k == 0:
            return 0
        for t, x_row, y in zip(task_ids, features, labels):
            r = self._row_counts[t]
            self._xs[t, r] = x_row
            self._ys[t, r] = y
            self._row_counts[t] = r + 1
        self._problems.clear()
        return k

    def append_undoable(self, task_ids, features, labels,
                        capacity: int | None = None) -> StoreUndo:
        """`append` plus an undo token that restores the store BITWISE
        (buffers, counts and capacity); one outstanding undo at a time."""
        task_ids = np.atleast_1d(np.asarray(task_ids, np.int64))
        old_cap = self.capacity
        old_counts = self._row_counts.copy()
        counts = old_counts.copy()
        slots = []
        for t in task_ids:
            if 0 <= t < self.num_tasks:
                r = int(counts[t])
                counts[t] = r + 1
                if r < old_cap:
                    slots.append((int(t), r, self._xs[t, r].copy(),
                                  self._ys[t, r].copy()))
        self.append(task_ids, features, labels, capacity)
        return StoreUndo(old_cap, old_counts, slots)

    def rollback(self, undo: StoreUndo) -> None:
        """Undo one `append_undoable`; the store is bitwise pre-append."""
        if undo.capacity != self.capacity:
            self._xs = np.ascontiguousarray(self._xs[:, :undo.capacity])
            self._ys = np.ascontiguousarray(self._ys[:, :undo.capacity])
        for t, r, x_prev, y_prev in undo.slots:
            self._xs[t, r] = x_prev
            self._ys[t, r] = y_prev
        self._row_counts = undo.row_counts.copy()
        self._problems.clear()

    def _grow(self, need: int) -> None:
        """Double capacity until `need` rows fit."""
        cap = max(self.capacity, 1)
        while cap < need:
            cap *= 2
        grown_x = np.zeros((self.num_tasks, cap, self.dim), np.float32)
        grown_y = np.zeros((self.num_tasks, cap), np.float32)
        grown_x[:, :self.capacity] = self._xs
        grown_y[:, :self.capacity] = self._ys
        self._xs, self._ys = grown_x, grown_y

    # ------------------------------------------------------- checkpoint ---

    def state(self) -> TaskStoreState:
        return TaskStoreState(self._xs.copy(), self._ys.copy(),
                              self._row_counts.copy())

    def buffers(self) -> TaskStoreState:
        """The buffers themselves, read-only views (no copy: a shard's
        record part or digest)."""
        views = [a.view() for a in (self._xs, self._ys, self._row_counts)]
        for a in views:
            a.flags.writeable = False
        return TaskStoreState(*views)

    def save(self, ckpt_dir: str, step: int,
             keep_last: int | None = None) -> str:
        """Write the buffers as `step_<step>.npz` under `ckpt_dir`."""
        return save(ckpt_dir, step, self.state(), keep_last=keep_last)

    @classmethod
    def restore(cls, ckpt_dir: str, step: int, loss_name: str,
                reg_name: str, lam: float) -> "TaskStore":
        """Rebuild a store from a `save` record, bitwise.

        The capacity is the record's: the leaves' shapes are read from
        their npy headers, then the leaves go through
        `repro_torch.checkpoint.restore` against a skeleton of those
        shapes (its key, dtype and CRC checks).  A torn or corrupt record
        raises `CheckpointCorruptError`, never a raw zip error.
        """
        path = _resolve_step_path(ckpt_dir, step)
        try:
            with zipfile.ZipFile(path) as record:
                shapes = [_npy_shape(record, key)
                          for key in (".xs", ".ys", ".row_counts")]
        except FileNotFoundError:
            raise
        except Exception as e:
            raise CheckpointCorruptError(
                path, [], f"unreadable store record: {e!r}")
        like = TaskStoreState(np.empty(shapes[0], np.float32),
                              np.empty(shapes[1], np.float32),
                              np.empty(shapes[2], np.int32))
        state = restore(ckpt_dir, step, like)
        return cls(state.xs, state.ys, state.row_counts, loss_name,
                   reg_name, lam)


def _npy_shape(record: zipfile.ZipFile, key: str) -> tuple:
    """The shape in the npy header of member `key`, without its data."""
    with record.open(key + ".npy") as f:
        major, _ = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if major == 1
                else np.lib.format.read_array_header_2_0)
        return read(f)[0]


def stack_ragged(xs_list: Sequence, ys_list: Sequence, loss_name: str,
                 reg_name: str, lam: float,
                 device: torch.device | str | None = None) -> MTLProblem:
    """Pad per-task cohorts straight into a ragged MTLProblem on `device`
    (`TaskStore.from_ragged(...).problem(device)`)."""
    return TaskStore.from_ragged(xs_list, ys_list, loss_name, reg_name,
                                 lam).problem(device)
