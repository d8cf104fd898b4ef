"""Background learner thread for `AMTLServer` — the concurrent chunk
runner, and its fault-tolerant supervisor (port of
`repro/serve/learner.py`).

The thread runs `AMTLServer._step_once`, which enters the server's own
CUDA stream itself: a `torch.cuda.stream` context holds only in the
thread that enters it, so every chunk, on this thread, on a restarted
one, or inline in `step()`, goes on the server's one stream.

The cooperative server interleaves `predict` and `step()` on one
thread, so every coalesce -> `engine.run` -> materialize chunk (and the
server-prox refresh inside it) stalls the request path — exactly the
blocking the asynchronous framework exists to avoid.  `BackgroundLearner`
moves that loop onto its own daemon thread:

  * loop: run one chunk via `AMTLServer._step_once()` (fold accepted
    labeled rows into the TaskStore, coalesce, `engine.run`,
    materialize the new iterate, atomic snapshot flip, auto-checkpoint
    cadence — all under the server's state lock, which the request
    path never takes);
  * idle: when the queue has no runnable chunk, park on a wake event
    that `submit_feedback` sets — no spin, sub-ms reaction to new
    feedback (a short timeout re-polls so a floored remainder that
    becomes runnable is never missed);
  * lifecycle: `start()` / `stop(drain=...)`.  `stop(drain=True)`
    keeps running chunks until the queue cannot produce another
    runnable chunk, then joins — with no concurrent submissions, the
    drained chunk log is exactly the cooperative `while step(): pass`
    loop's (coalescing is deterministic in the queue contents), which
    is the thread-vs-cooperative bitwise contract
    tests/test_torch_serve_threaded.py pins down;
  * failure: an exception on the learner thread is captured, the
    thread exits (the server keeps serving the last committed
    snapshot), and the exception is re-raised on `stop()`/`join()` —
    a dead learner is never silent.  A `join` that times out leaves
    the learner joinable again: a later `stop()`/`join()` retries
    cleanly and still surfaces the captured exception exactly once.

`LearnerSupervisor` wraps a `BackgroundLearner` with the same
start/wake/stop surface plus bounded auto-restart: a monitor thread
waits on the learner's exit event, and on a crash either restarts it
under exponential backoff (the restart re-serves the last committed
snapshot — the atomic-flip contract makes a mid-chunk death lose only
that chunk's coalesced events, the platform's documented crash window)
or, once `restart_limit` crashes have been healed, trips the server's
circuit breaker: the server latches into frozen-serving mode
(predictions keep flowing, feedback is rejected with a "breaker"
receipt reason) and the terminal exception surfaces on `stop()`.  A
dead learner heals or it declares itself down — never silently frozen.
"""
from __future__ import annotations

import threading
import time
from typing import Optional


class BackgroundLearner:
    """Owns the learner thread of one `AMTLServer` (see module doc)."""

    def __init__(self, server, *, idle_wait_s: float = 0.002,
                 name: str = "amtl-learner"):
        self._server = server
        self._idle_wait_s = float(idle_wait_s)
        self._name = name
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._exit = threading.Event()  # set whenever no loop is running
        self._exit.set()
        self._join_lock = threading.Lock()
        self._draining = False
        self._exc: Optional[BaseException] = None
        self.chunks = 0     # chunks run on this thread (across restarts)
        self.events = 0     # events learned on this thread

    # ---------------------------------------------------------- lifecycle
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def exited(self) -> threading.Event:
        """Set while no learner loop is running (crash, drain, or never
        started); the supervisor's monitor parks on it."""
        return self._exit

    def start(self) -> None:
        if self.running:
            raise RuntimeError("learner thread is already running")
        self._maybe_reraise()
        self._stop.clear()
        self._wake.clear()
        self._draining = False
        self._exit.clear()
        self._thread = threading.Thread(
            target=self._loop, name=self._name, daemon=True)
        self._thread.start()

    def wake(self) -> None:
        """Called by `submit_feedback`: new work may be runnable."""
        self._wake.set()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> int:
        """Stop the thread and join it; returns events learned on it.

        drain=True finishes every runnable chunk first (the queue may
        still hold a floored, un-runnable remainder — same as the
        cooperative drain loop).  drain=False exits at the next chunk
        boundary, leaving the rest queued.  Re-raises any exception the
        learner thread died with.
        """
        self._draining = drain
        self._stop.set()
        self._wake.set()
        return self.join(timeout)

    def join(self, timeout: Optional[float] = None) -> int:
        """Join the thread (if any) and surface its exception.

        A timed-out join raises TimeoutError but leaves the learner
        joinable: `self._thread` stays set so a later `stop()`/`join()`
        retries the join, and a captured exception stays pending until
        a join completes — it is surfaced exactly once, never lost to
        the timeout path.
        """
        with self._join_lock:
            thread = self._thread
            if thread is not None:
                thread.join(timeout)
                if thread.is_alive():
                    pending = (" (a captured learner exception is still "
                               "pending and will surface on the next "
                               "successful stop/join)"
                               if self._exc is not None else "")
                    raise TimeoutError(
                        f"learner thread did not stop within {timeout}s; "
                        f"retry stop()/join(){pending}")
                self._thread = None
            self._maybe_reraise()
            return self.events

    def take_exception(self) -> Optional[BaseException]:
        """Consume the captured exception (supervisor path); the normal
        stop/join re-raise then stays silent — exactly-once surfacing
        moves to the caller."""
        exc, self._exc = self._exc, None
        return exc

    def _maybe_reraise(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    # --------------------------------------------------------------- loop
    def _loop(self) -> None:
        try:
            while True:
                if self._stop.is_set() and not self._draining:
                    break
                ran = self._server._step_once()
                if ran:
                    self.chunks += 1
                    self.events += ran
                    continue
                if self._stop.is_set():
                    break               # drained: no runnable chunk left
                self._wake.wait(self._idle_wait_s)
                self._wake.clear()
        except BaseException as e:      # surfaced on stop()/join()
            self._exc = e
        finally:
            self._exit.set()


class LearnerSupervisor:
    """Bounded auto-restart around one `BackgroundLearner`.

    Same lifecycle surface as the learner (`start`/`wake`/`stop`/
    `running`/`chunks`/`events`), so `AMTLServer` holds either
    interchangeably.  `limit` is the number of crashes the supervisor
    will heal; crash k restarts after `backoff_s * 2**k`.  Crash
    `limit` + 1 trips the server's circuit breaker instead, and the
    terminal exception is re-raised (once) by `stop()` — as is a crash
    whose backoff was cut short by `stop()`.
    """

    def __init__(self, server, *, limit: int, backoff_s: float,
                 idle_wait_s: float = 0.002):
        self._server = server
        self._learner = BackgroundLearner(server, idle_wait_s=idle_wait_s)
        self.limit = int(limit)
        self.backoff_s = float(backoff_s)
        self._stop_evt = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.restarts = 0            # crashes healed by a restart
        self.crashes = 0             # learner-thread deaths observed
        self.crash_log: list = []    # repr of each crash, in order
        self.recovery_ms: list = []  # crash-detect -> re-serving, wall ms
        self.breaker_tripped = False
        self._pending_exc: Optional[BaseException] = None

    # ---------------------------------------------------------- lifecycle
    @property
    def running(self) -> bool:
        # The monitor IS the supervised learner's liveness: it stays up
        # through crash/backoff gaps where the learner thread is dead
        # but the system is still healing.
        return self._monitor is not None and self._monitor.is_alive()

    @property
    def chunks(self) -> int:
        return self._learner.chunks

    @property
    def events(self) -> int:
        return self._learner.events

    def start(self) -> None:
        if self.running:
            raise RuntimeError("learner thread is already running")
        if self.breaker_tripped:
            raise RuntimeError(
                "learner circuit breaker is latched (restart budget "
                "exhausted); the server is in frozen-serving mode")
        self._stop_evt.clear()
        self._learner.start()
        self._monitor = threading.Thread(
            target=self._run, name="amtl-learner-supervisor", daemon=True)
        self._monitor.start()

    def wake(self) -> None:
        self._learner.wake()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> int:
        """Stop learner + monitor; re-raise an unhealed crash once.

        An unhealed crash is one the monitor never restarted past: it
        either latched the breaker, had its backoff cut short by this
        stop, or happened during the stop-drain itself (the monitor
        stands down once stop is requested).  Healed crashes do not
        re-raise — they are telemetry (`crash_log`), not failures.
        """
        self._stop_evt.set()
        exc: Optional[BaseException] = None
        try:
            events = self._learner.stop(drain=drain, timeout=timeout)
        except TimeoutError:
            raise  # learner still joinable; monitor still standing by
        except BaseException as e:
            exc = e  # crash during the stop-drain window
            events = self._learner.events
        monitor = self._monitor
        if monitor is not None:
            monitor.join(timeout)
            if monitor.is_alive():
                raise TimeoutError(
                    f"learner supervisor did not stop within {timeout}s; "
                    "retry stop()")
            self._monitor = None
        pending, self._pending_exc = self._pending_exc, None
        exc = exc if exc is not None else pending
        if exc is not None:
            raise exc
        return events

    # -------------------------------------------------------------- monitor
    def _run(self) -> None:
        while True:
            self._learner.exited.wait()
            if self._stop_evt.is_set():
                return
            exc = self._learner.take_exception()
            if exc is None:
                return  # clean exit without stop(): nothing to heal
            self.crashes += 1
            self.crash_log.append(repr(exc))
            if self.restarts >= self.limit:
                self._pending_exc = exc
                self.breaker_tripped = True
                self._server._trip_breaker(exc)
                return
            started = time.perf_counter()
            if self._stop_evt.wait(self.backoff_s * (2.0 ** self.restarts)):
                self._pending_exc = exc  # stop cut the heal short
                return
            self.restarts += 1
            self._learner.start()
            self._learner.wake()
            self.recovery_ms.append(
                1e3 * (time.perf_counter() - started))
