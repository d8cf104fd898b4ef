"""Ranks of an n-rank task mesh stepping in lockstep behind one
`AMTLServer`: the wire of a boundary and the store's shards.

The multi-rank server is SPMD: every rank runs the same calls (`predict`,
`submit_feedback`, `step`, `start_learner`, `stop_learner`, `checkpoint`,
`resume`), as `launch.amtl_sharded` runs the engine, and every rank serves
the same snapshots.  Each rank keeps only its own tasks' part of the data:
its block of the engine's problem on its device and its shard of the
store on the host (a `TaskStore` of tasks [rank * T / n, (rank + 1) *
T / n)).

Rank 0 decides every boundary: its admission and coalescing pick the
chunk and the rows to fold, and its learner loop decides when the world
stops.  A boundary is, on every rank:

  1. one all_gather of a host header of HEADER + T int64 (`exchange`):
     rank 0's carries the decision (the chunk's events, the rows to fold,
     the events taken from each task, the STOP and CHECKPOINT flags); each
     rank's carries BREAKER once its learner's circuit breaker latched;
  2. where rows fold, one broadcast of their task ids and one of the rows
     (features and label) from rank 0 (`broadcast_rows`); each rank
     appends its own tasks' rows to its shard, which grows with the whole
     store's capacity (`global_counts`), so every block keeps the bytes of
     the one-rank store's;
  3. `engine.run` (collectives at the prox refreshes), then the flip: one
     gather of the (d, T) iterate, which every rank serves from, and the
     non-finite guard on it (the same bytes, so the same decision);
  4. a checkpoint where flagged or on the `checkpoint_every` cadence.

A breaker flag from any rank latches every rank's breaker at that
boundary and runs nothing: the world serves frozen together.

Every collective of a rank is issued by one thread: the caller's while no
learner runs (construction, `resume`, `step()`, `checkpoint()`), the
learner thread's while it runs (a threaded `checkpoint()` is handed to
it).  `predict` and `serving()` never touch the process group.

The store record is the reference's (`TaskStore.save`): each rank writes
its rows to a part file, rank 0 streams the parts into the record
(`checkpoint.save_streamed`), and a resume reads each rank's rows of the
record from the file (`checkpoint.read_rows`), their CRC32s joined over
the ranks against the record's manifest.  No rank gathers the store.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.checkpoint import CheckpointCorruptError
from repro_torch.checkpoint.checkpoint import _resolve_step_path
from repro_torch.data.store import TaskStore
from repro_torch.distributed.sharding import broadcast, gather_shards

# the header: fields, then T taken counts
EVENTS, ROWS, FLAGS, HEADER = 0, 1, 2, 3
STOP, CHECKPOINT, BREAKER = 1, 2, 4
# streamed bytes a chunk of a part file
CHUNK_BYTES = 1 << 26


class Lockstep:
    """A rank's side of the wire (see the module doc)."""

    def __init__(self, mesh, num_tasks: int):
        self.mesh = mesh
        self.rank = mesh.rank
        self.size = mesh.size
        self.num_tasks = num_tasks
        self.n_local = mesh.n_local(num_tasks)
        self.lo = self.rank * self.n_local
        self.hi = self.lo + self.n_local
        # host tensors for gloo, the rank's card for NCCL
        self.wire = mesh.device if mesh.backend == "nccl" else \
            torch.device("cpu")

    # ------------------------------------------------------------- wire --
    def header(self) -> np.ndarray:
        return np.zeros(HEADER + self.num_tasks, np.int64)

    def exchange(self, head: np.ndarray) -> np.ndarray:
        """Every rank's int64 vector (a header: HEADER + T), (size, len),
        in rank order."""
        x = torch.as_tensor(np.asarray(head, np.int64)).reshape(1, -1)
        return gather_shards(x.to(self.wire), self.mesh).cpu().numpy()

    def broadcast_rows(self, rows, k: int, d: int):
        """Rank 0's k folded rows on every rank: (task ids (k,), features
        (k, d), labels (k,)).  `rows` is rank 0's list of (task, x, y)."""
        ids = torch.zeros(k, dtype=torch.int64)
        xy = torch.zeros((k, d + 1), dtype=torch.float32)
        if self.rank == 0:
            ids = torch.as_tensor(np.asarray([r[0] for r in rows], np.int64))
            xy = torch.as_tensor(np.concatenate(
                [np.stack([r[1] for r in rows]),
                 np.asarray([r[2] for r in rows], np.float32)[:, None]],
                axis=1))
        ids = broadcast(ids.to(self.wire), self.mesh).cpu().numpy()
        xy = broadcast(xy.to(self.wire), self.mesh).cpu().numpy()
        return ids, xy[:, :d], xy[:, d]

    def agree(self, status: int) -> np.ndarray:
        """Every rank's status int, so that all ranks take one decision."""
        return self.exchange([status])[:, 0]

    def global_counts(self, block_counts: np.ndarray) -> np.ndarray:
        """The whole store's (T,) row counts from each rank's block."""
        return self.exchange(block_counts).reshape(-1).astype(np.int32)

    # --------------------------------------------------------- the store --
    def fold(self, store: TaskStore, counts: np.ndarray, ids: np.ndarray,
             xs: np.ndarray, ys: np.ndarray):
        """Append the rank's rows of one fold to its shard, grown to the
        whole store's capacity after the fold.  Returns (the shard's undo,
        the new global counts)."""
        counts = counts.copy()
        np.add.at(counts, ids, 1)
        mine = (ids >= self.lo) & (ids < self.hi)
        undo = store.append_undoable(ids[mine] - self.lo, xs[mine], ys[mine],
                                     capacity=int(counts.max()))
        return undo, counts

    def save_store(self, store: TaskStore, counts: np.ndarray,
                   store_dir: str, step: int, keep_last) -> str:
        """Write the whole store's record at `step` (a collective): each
        rank's rows to a part file, then rank 0 streams the parts into the
        record.  Every rank returns once the record is in place."""
        parts = os.path.join(store_dir, f".parts_{step:08d}")
        ok = 1
        try:
            os.makedirs(parts, exist_ok=True)
            buffers = store.buffers()
            for name, arr in (("xs", buffers.xs), ("ys", buffers.ys)):
                np.save(os.path.join(parts, f"{name}.{self.rank}.npy"), arr)
        except OSError:
            ok = 0
        if not self.agree(ok).all():
            raise OSError(f"a rank could not write its part of the store "
                          f"record under {parts}")
        ok, path = 1, os.path.join(store_dir, f"step_{step:08d}.npz")
        if self.rank == 0:
            try:
                path = checkpoint.save_streamed(
                    store_dir, step, self._leaves(parts, store, counts),
                    keep_last=keep_last)
            except OSError:
                ok = 0
            shutil.rmtree(parts, ignore_errors=True)
        if not self.agree(ok).all():
            raise OSError(f"rank 0 could not write the store record {path}")
        return path

    def _leaves(self, parts: str, store: TaskStore, counts: np.ndarray):
        """The record's leaves, each streamed from the ranks' part files in
        rank order."""
        def chunks(name: str):
            # plain reads into one buffer (a map of the parts would count
            # them in the rank's resident bytes)
            buf = np.empty(CHUNK_BYTES, np.uint8)
            for r in range(self.size):
                with open(os.path.join(parts, f"{name}.{r}.npy"), "rb") as f:
                    major, _ = np.lib.format.read_magic(f)
                    (np.lib.format.read_array_header_1_0 if major == 1
                     else np.lib.format.read_array_header_2_0)(f)
                    while n := f.readinto(buf):
                        yield buf[:n]
        cap, d = store.capacity, store.dim
        return [(".xs", (self.num_tasks, cap, d), np.float32, chunks("xs")),
                (".ys", (self.num_tasks, cap), np.float32, chunks("ys")),
                (".row_counts", (self.num_tasks,), np.int32,
                 [counts.astype(np.int32)])]

    def restore_store(self, store_dir: str, step: int, loss_name: str,
                      reg_name: str, lam: float):
        """The rank's shard of store record `step` and the whole store's
        row counts (a collective).  Each rank reads its own rows from the
        file; the ranks' CRC32s, joined in rank order, must give the
        record's manifest.  Raises FileNotFoundError or
        CheckpointCorruptError on every rank alike."""
        path = _resolve_step_path(store_dir, step)
        status, crcs, out = 0, np.zeros(4, np.int64), None
        try:
            manifest = checkpoint.read_manifest(path)
            if set(manifest) != {".xs", ".ys", ".row_counts"}:
                raise CheckpointCorruptError(
                    path, [], f"not a store record: leaves {sorted(manifest)}")
            counts, c_crc, _ = checkpoint.read_rows(path, ".row_counts", 0,
                                                    self.num_tasks)
            if c_crc != manifest[".row_counts"]:
                raise CheckpointCorruptError(path, [".row_counts"],
                                             "leaf bytes fail their CRC32")
            xs, x_crc, x_shape = checkpoint.read_rows(path, ".xs", self.lo,
                                                      self.hi)
            ys, y_crc, _ = checkpoint.read_rows(path, ".ys", self.lo, self.hi)
            if x_shape[0] != self.num_tasks:
                raise CheckpointCorruptError(
                    path, [".xs"], f"{x_shape[0]} tasks, the server has "
                    f"{self.num_tasks}")
            crcs[:] = (x_crc, xs.nbytes, y_crc, ys.nbytes)
            out = (xs, ys, counts)
        except FileNotFoundError:
            status = 1
        except (CheckpointCorruptError, ValueError, OSError):
            status = 2
        heads = self.exchange(np.concatenate([[status], crcs]))
        if (heads[:, 0] == 1).any():
            raise FileNotFoundError(path)
        if (heads[:, 0] == 2).any():
            raise CheckpointCorruptError(path, [], "a rank could not read "
                                         "its rows of the store record")
        damaged = [key for key, col in ((".xs", 1), (".ys", 3))
                   if checkpoint.crc32_concat(heads[:, col:col + 2])
                   != manifest[key]]
        if damaged:
            raise CheckpointCorruptError(path, damaged,
                                         "leaf bytes fail their CRC32")
        xs, ys, counts = out
        store = TaskStore(xs, ys, counts[self.lo:self.hi], loss_name,
                          reg_name, lam, copy=False)
        return store, counts.astype(np.int32)
