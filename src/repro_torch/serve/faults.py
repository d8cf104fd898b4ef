"""Deterministic fault injection for the learn-while-serve platform
(port of `repro/serve/faults.py`).

Every recovery path of the server — supervised learner restart, checkpoint
fallback restore, the non-finite guard's quarantine-and-rollback — is a
claim about behaviour under failure, and timing-based chaos cannot test
such claims bitwise.  A `FaultPlan` scripts the failure points instead:
the server calls the plan's hooks at fixed places in its control flow
(chunk runner, checkpoint writer, feedback admission), the plan counts
those calls, and fires exactly at the scripted indices.  Recovery is
then a pure function of (traffic, plan) — the fault suite replays the
surviving chunk log through one `engine.run` and asserts bitwise
equality, exactly like the no-fault tests do.

The default plan is a no-op: hooks still run (an integer compare each),
so the guarded code path is IDENTICAL with and without faults armed —
there is no "fault build" whose control flow differs from prod.

Scripted points (all 0-based call indices, deterministic given the
single-threaded chunk runner):

  * `crash_on_chunks`: raise `InjectedFault` in the chunk runner just
    before the k-th runnable chunk's `engine.run`.  The chunk's
    coalesced events are lost — the platform's documented at-most-once
    crash window — and a supervised learner auto-restarts past it.
  * `poison_iterate_on_chunks`: overwrite the k-th chunk's materialized
    iterate with NaN before the snapshot flip, exercising the
    non-finite guard (quarantine + state/store rollback).
  * `nan_feedback`: `(call, row)` pairs; NaN the feature row `row` of
    the call-th LABELED `submit_feedback` before admission, exercising
    the admission-side non-finite reject.
  * `fail_checkpoint_calls`: raise `InjectedFault` inside the k-th
    `checkpoint()` call AFTER the store record lands but BEFORE the
    engine record is written — the documented crash-split window that
    `resume`'s newest-valid-record scans must bridge.

On-disk damage (bit rot, torn writes) is not a server control-flow
event, so it lives in module functions instead of the plan:
`truncate_record` tears a record's tail off (unreadable zip);
`corrupt_leaf` flips payload bytes behind a VALID zip container — the
damage only the `__manifest__` CRC layer can see.
"""
from __future__ import annotations

import os
import zipfile
from typing import Collection, Iterable, Optional, Tuple

import numpy as np
import torch


class InjectedFault(RuntimeError):
    """A scripted failure fired by a `FaultPlan` hook."""


class FaultPlan:
    """Scripted failure points for one `AMTLServer`; see module doc.

    Stateful (each hook advances a call counter), so one plan drives
    one server — build a fresh plan per server, and identical plans
    against identical traffic reproduce identical failures.
    """

    def __init__(self, *,
                 crash_on_chunks: Collection[int] = (),
                 poison_iterate_on_chunks: Collection[int] = (),
                 nan_feedback: Iterable[Tuple[int, int]] = (),
                 fail_checkpoint_calls: Collection[int] = ()):
        self._crash = frozenset(int(c) for c in crash_on_chunks)
        self._poison = frozenset(int(c) for c in poison_iterate_on_chunks)
        self._nan_rows: dict[int, list[int]] = {}
        for call, row in nan_feedback:
            self._nan_rows.setdefault(int(call), []).append(int(row))
        self._fail_ckpt = frozenset(int(c) for c in fail_checkpoint_calls)
        self._chunk_i = 0
        self._fb_i = 0
        self._ckpt_i = 0

    # ------------------------------------------------------ server hooks --

    def begin_chunk(self) -> int:
        """Called once per runnable chunk (after coalescing found
        events); returns this chunk's 0-based index."""
        idx = self._chunk_i
        self._chunk_i += 1
        return idx

    def crash_point(self, chunk_idx: int) -> None:
        """Raise if chunk `chunk_idx` is scripted to crash the runner."""
        if chunk_idx in self._crash:
            raise InjectedFault(
                f"scripted learner crash at chunk {chunk_idx}")

    def poison(self, chunk_idx: int, iterate):
        """NaN the materialized iterate when scripted, else pass it."""
        if chunk_idx in self._poison:
            return torch.full_like(iterate, float("nan"))
        return iterate

    def feedback(self, features: np.ndarray,
                 labels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Called once per LABELED submit_feedback, before admission;
        returns (features, labels), NaN-poisoned when scripted."""
        call = self._fb_i
        self._fb_i += 1
        rows = self._nan_rows.get(call)
        if rows:
            features = np.array(features, np.float32, copy=True)
            for r in rows:
                features[r, 0] = np.nan
        return features, labels

    def checkpoint_point(self) -> None:
        """Called between the store record write and the engine record
        write; raises when this checkpoint call is scripted to die."""
        call = self._ckpt_i
        self._ckpt_i += 1
        if call in self._fail_ckpt:
            raise InjectedFault(
                f"scripted crash in checkpoint call {call} (store record "
                "written, engine record not)")


# ------------------------------------------------------- on-disk damage --

def truncate_record(path: str, keep_bytes: Optional[int] = None) -> int:
    """Tear the tail off a record (default: keep the first half).

    Models a crash mid-write or a short copy: the zip central directory
    lives at the end of the file, so the result is unreadable as a
    whole — `verify`/`restore` raise `CheckpointCorruptError` with no
    damaged-leaf attribution.  Returns the bytes kept.
    """
    size = os.path.getsize(path)
    keep = size // 2 if keep_bytes is None else int(keep_bytes)
    keep = max(0, min(keep, size))
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def corrupt_leaf(path: str, key: Optional[str] = None) -> str:
    """Flip a payload byte of one leaf behind a VALID zip container.

    The zip member is rewritten (container CRC recomputed over the
    flipped bytes), so only the embedded `__manifest__` CRC layer can
    see the damage — this models silent bit rot that the file format
    does not catch.  `key` is the flattened leaf key (without the
    `.npy` suffix); default is the first non-manifest leaf.  Returns
    the damaged member name.
    """
    with zipfile.ZipFile(path) as z:
        members = {n: z.read(n) for n in z.namelist()}
    if key is not None:
        name = key if key in members else key + ".npy"
        if name not in members:
            raise KeyError(f"no member {key!r} in {path}: "
                           f"{sorted(members)}")
    else:
        name = next(n for n in sorted(members)
                    if not n.startswith("__manifest__"))
    blob = bytearray(members[name])
    blob[-1] ^= 0xFF  # last byte = array payload, well past the npy header
    members[name] = bytes(blob)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for n, data in members.items():
            z.writestr(n, data)
    return name
