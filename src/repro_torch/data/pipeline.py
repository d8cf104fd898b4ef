"""Host -> device batching (port of `repro/data/pipeline.py`).

`ShardedBatcher` wraps a host-side numpy batch iterator and places each
batch on `device`, one batch ahead of the caller: while the step on batch
i runs, batch i + 1 is already copied (from pinned host memory, without
blocking the host, where the device is a card).  Placement on a mesh waits
for the sharded LM (ROADMAP.md, Queue 1 item 11(i)).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


class ShardedBatcher:
    def __init__(self, it: Iterator[dict],
                 device: torch.device | str | None = None):
        self._it = it
        self._device = resolve_device(device)
        self._next: Optional[dict] = None

    def _place(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self._device.type == "cuda":
                t = t.pin_memory().to(self._device, non_blocking=True)
            out[k] = t
        return out

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._next is None:
            self._next = self._place(next(self._it))
        out = self._next
        try:
            self._next = self._place(next(self._it))
        except StopIteration:
            self._next = None
        return out
