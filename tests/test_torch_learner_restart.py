"""The learner thread's restart against a concurrent join (the port's
`serve/learner.py`, no reference counterpart needed: the race is the
port's own).

A supervisor restarts a crashed learner from its monitor thread while the
caller's `stop()` may be joining.  Before the restart took the join lock,
a join that ran between the new thread's creation and its start raised
"cannot join thread before it is started" (seen once in chip_smoke.py
phase 20's chaos drive on an H100).  Here a thread class whose start
sleeps opens that window on purpose.
"""
import threading
import time
import types

import pytest

pytest.importorskip("torch")

from repro_torch.serve import learner as learner_mod  # noqa: E402


class IdleServer:
    lockstep = None

    def _step_once(self) -> int:
        return 0


def test_join_waits_for_a_restart_in_progress(monkeypatch):
    learner = learner_mod.BackgroundLearner(IdleServer())
    learner.request_stop(drain=False)     # the new loop exits at once
    starting = threading.Event()

    class SlowStart(threading.Thread):
        def start(self):
            starting.set()
            time.sleep(0.2)
            super().start()

    monkeypatch.setattr(learner_mod, "threading",
                        types.SimpleNamespace(Thread=SlowStart))
    restarter = threading.Thread(target=learner.restart)
    restarter.start()
    assert starting.wait(5)
    assert learner.join(timeout=5) == 0   # waits for the start, then joins
    restarter.join(5)
    assert not learner.running and learner.exited.is_set()
