"""Latency-SLO-driven admission control for the learning-while-serving
front-end (a copy of `repro/serve/admission.py`, which is numpy only).

A serving system that learns in the background has one global knob that
trades learning throughput for request latency: the per-chunk event
budget (`ServeConfig.chunk_events`).  Bigger chunks amortize the server
prox over more events but hold the engine (and, on a shared host, the
CPU the request path also wants) longer per `engine.run`.
`LatencySLOController` closes that loop: the request path records its
per-batch predict latency, and the controller deterministically shrinks
the admitted chunk budget while the rolling p95 violates the SLO and
restores it while the tail is healthy.

The control law is a PURE FUNCTION of the recorded latency sequence
(tested in tests/test_torch_serve_threaded.py), which is what keeps the
threaded server's chunk-size trace explainable after the fact:

  * Latencies are consumed in TUMBLING windows of `window` samples.
  * At each window close, p95 = percentile(window, 95).
      - p95 >  slo_ms: degrade one level (the admitted budget halves,
        floored to a positive multiple of `events_per_step`; levels
        past the floor are clamped, the violation still counts).
      - p95 <= slo_ms: restore one level (toward the configured budget).
  * Every window close is logged as an `SLODecision`; `snapshot()`
    exposes the full trace plus the per-sample violation count
    (`violations`, the serving bench's `slo_violations` key).

Thread model: `record` takes a controller-private mutex (never the
learner's state lock — a predict is never blocked behind an in-flight
`engine.run` chunk); `chunk_events` is a single int attribute read on
the learner side, so the coalescer sees each level change atomically.
"""
from __future__ import annotations

import threading
from typing import Any, NamedTuple, Optional

import numpy as np


class SLODecision(NamedTuple):
    """One tumbling-window close of the controller (logged in order).

    sample        1-based index of the latency sample that closed the
                  window (== multiples of `window`)
    p95_ms        the window's 95th-percentile latency
    level_before  degradation level entering the decision
    level         degradation level after it (0 = full budget)
    chunk_events  admitted per-chunk event budget after the decision
    """
    sample: int
    p95_ms: float
    level_before: int
    level: int
    chunk_events: int


def degraded_budget(base: int, per: int, level: int) -> int:
    """The admitted chunk budget at a degradation level: halved per
    level, floored to a positive multiple of `per` (the engine's
    events_per_step, the smallest runnable chunk)."""
    if level <= 0:
        return base
    return max(per, (base >> level) // per * per)


class LatencySLOController:
    """Rolling-p95 admission controller (see module doc for the law)."""

    def __init__(self, slo_ms: float, chunk_events: int,
                 events_per_step: int, window: int = 32):
        if slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        if window < 1:
            raise ValueError(f"slo_window must be >= 1, got {window}")
        self.slo_ms = float(slo_ms)
        self.base_chunk_events = int(chunk_events)
        self.events_per_step = int(events_per_step)
        self.window = int(window)
        # deepest level that still changes the budget; violations at the
        # floor clamp here so one recovery window restores real budget
        self._max_level = 0
        while degraded_budget(chunk_events, events_per_step,
                              self._max_level + 1) \
                < degraded_budget(chunk_events, events_per_step,
                                  self._max_level):
            self._max_level += 1
        self._mutex = threading.Lock()
        self._pending: list[float] = []   # current (open) tumbling window
        self._samples = 0
        self.level = 0
        self.chunk_events = int(chunk_events)   # learner-side atomic read
        self.violations = 0                     # samples over the SLO
        self.decisions: list[SLODecision] = []

    def record(self, latency_ms: float) -> None:
        """Feed one per-batch predict latency; decides at window closes."""
        with self._mutex:
            self._samples += 1
            self.violations += latency_ms > self.slo_ms
            self._pending.append(float(latency_ms))
            if len(self._pending) < self.window:
                return
            p95 = float(np.percentile(self._pending, 95))
            self._pending = []
            before = self.level
            if p95 > self.slo_ms:
                self.level = min(self.level + 1, self._max_level)
            else:
                self.level = max(self.level - 1, 0)
            self.chunk_events = degraded_budget(
                self.base_chunk_events, self.events_per_step, self.level)
            self.decisions.append(SLODecision(
                self._samples, p95, before, self.level, self.chunk_events))

    @property
    def degraded(self) -> bool:
        return self.level > 0

    def snapshot(self) -> dict[str, Any]:
        """Telemetry for `AMTLServer.stats()["slo"]` (decision trace
        included — the controller's choices are part of the record)."""
        with self._mutex:
            return {
                "slo_ms": self.slo_ms,
                "window": self.window,
                "samples": self._samples,
                "violations": int(self.violations),
                "level": self.level,
                "chunk_events": self.chunk_events,
                "base_chunk_events": self.base_chunk_events,
                "decisions": [d._asdict() for d in self.decisions],
            }


def make_controller(slo_ms: Optional[float], chunk_events: int,
                    events_per_step: int,
                    window: int) -> Optional[LatencySLOController]:
    """None when the SLO is unset — the server then never times predicts."""
    if slo_ms is None:
        return None
    return LatencySLOController(slo_ms, chunk_events, events_per_step,
                                window=window)
