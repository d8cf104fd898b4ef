"""The port's concurrent learn-while-serve front end: the background
learner thread, the atomic snapshot flip and the latency-SLO admission
controller (the contracts of tests/test_serve_threaded.py on the port).

  * NO TORN READS: every snapshot a predict thread observes while the
    learner runs is bitwise a chunk-boundary iterate of the server's own
    chunk log.
  * DRAIN == COOPERATIVE: with the feedback queued before the learner
    starts, `start_learner()` ... `stop_learner(drain=True)` reproduces
    the cooperative `while step(): pass` loop's chunk log and state
    bitwise.
  * REPLAY LAW: with submissions racing the learner, the final state is
    bitwise ONE `engine.run(init, offs, sum(chunk_log))`.
  * SLO PURITY: the controller's decision trace is a pure function of
    the latency sequence, and the port's trace is the reference's.

The assertions hold whatever the threads' timing: a race changes which
chunk sizes are coalesced, never whether the state replays them.
"""
import os
import re
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import LatencySLOController as JController  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.interop import state_to_numpy  # noqa: E402
from repro_torch.serve import (AMTLServer, LatencySLOController,  # noqa: E402
                               ServeConfig, degraded_budget)


@pytest.fixture(scope="module")
def problem(small_problem):
    return rt.problem_from_numpy(np.asarray(small_problem.xs),
                                 np.asarray(small_problem.ys), "lstsq",
                                 "nuclear", 0.1, device="cpu")


def _cfg(problem, engine="delta", tau=3, **kw):
    if engine == "batch":
        kw.setdefault("event_batch", 4)
        kw.setdefault("prox_every", kw["event_batch"])
    return rt.AMTLConfig(eta=1.0 / problem.lipschitz(), eta_k=0.7, tau=tau,
                         engine=engine, **kw)


def _w0(problem):
    return np.zeros((problem.dim, problem.num_tasks), np.float32)


def _server(problem, cfg, serve_cfg=ServeConfig(chunk_events=4), key=0):
    return AMTLServer(problem, cfg, _w0(problem), prng.key_from_seed(key),
                      serve_cfg, device="cpu")


def _requests(problem, n, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, problem.num_tasks, size=n)
    x = rng.standard_normal((n, problem.dim)).astype(np.float32)
    return t, x


def _plain_run(problem, cfg, n, key=0):
    eng = rt.make_engine(problem, cfg, device="cpu")
    return eng.run(eng.init(_w0(problem), prng.key_from_seed(key)), None, n)


def _assert_states_equal(a, b, msg=""):
    for la, lb in zip(state_to_numpy(a), state_to_numpy(b), strict=True):
        np.testing.assert_array_equal(la, lb, err_msg=msg)


def _boundary_iterates(problem, cfg, chunk_log):
    """event -> iterate bytes at every chunk boundary of `chunk_log`."""
    eng = rt.make_engine(problem, cfg, device="cpu")
    state = eng.init(_w0(problem), prng.key_from_seed(0))
    out = {0: eng.iterate(state).numpy().tobytes()}
    event = 0
    for n in chunk_log:
        state = eng.run(state, None, n)
        event += n
        out[event] = eng.iterate(state).numpy().tobytes()
    return out


# --------------------------------------------------------- torn-read stress
def test_no_torn_reads_under_concurrent_predict_load(problem):
    cfg = _cfg(problem, "delta")
    server = _server(problem, cfg)
    t, x = _requests(problem, 8, seed=1)
    observed = [[] for _ in range(4)]
    stop = threading.Event()

    def hammer(slot):
        while True:
            snap = server.serving()
            server.predict(t, x)
            observed[slot].append(snap)
            if stop.is_set():
                break

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # switch threads often
    try:
        server.start_learner()
        for th in threads:
            th.start()
        rng = np.random.default_rng(7)
        for _ in range(25):
            server.submit_feedback(rng.integers(0, problem.num_tasks,
                                                size=rng.integers(1, 6)))
        server.stop_learner(drain=True, timeout=120)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=120)
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)

    assert sum(server.chunk_log) > 0
    boundaries = _boundary_iterates(problem, cfg, server.chunk_log)
    for snaps in observed:
        assert snaps
        for snap in snaps:
            assert snap.event in boundaries
            assert snap.v.numpy().tobytes() == boundaries[snap.event]
    final = server.serving()
    assert final.event == sum(server.chunk_log)
    assert final.v.numpy().tobytes() == boundaries[final.event]


def test_threaded_final_state_replays_chunk_log(problem):
    cfg = _cfg(problem, "batch")
    server = _server(problem, cfg, ServeConfig(chunk_events=8))
    server.start_learner()
    rng = np.random.default_rng(0)
    for _ in range(20):
        server.submit_feedback(rng.integers(0, problem.num_tasks,
                                            size=rng.integers(1, 7)))
    server.stop_learner(drain=True)
    assert sum(server.chunk_log) > 0
    _assert_states_equal(server._state,
                         _plain_run(problem, cfg, sum(server.chunk_log)))


# ------------------------------------------------------ drain == cooperative
@pytest.mark.parametrize("engine", ("delta", "batch"))
def test_drain_then_join_equals_cooperative_loop_bitwise(problem, engine):
    cfg = _cfg(problem, engine)
    fb = [i % problem.num_tasks for i in range(13)]
    sc = ServeConfig(chunk_events=8, task_chunk_quota=3)
    a = _server(problem, cfg, sc)
    b = _server(problem, cfg, sc)
    a.submit_feedback(fb)
    b.submit_feedback(fb)
    a.start_learner()
    learned = a.stop_learner(drain=True)
    while b.step():
        pass
    assert learned == sum(a.chunk_log)
    assert a.chunk_log == b.chunk_log
    assert a.pending_feedback == b.pending_feedback
    _assert_states_equal(a._state, b._state, engine)
    assert torch.equal(a.iterate(), b.iterate())


def test_threaded_then_resume_matches_cooperative(problem, tmp_path):
    cfg = _cfg(problem, "delta")
    sc = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path), keep_last=2)
    fb = [i % problem.num_tasks for i in range(9)]
    a = _server(problem, cfg, sc, key=2)
    ref = _server(problem, cfg, sc._replace(ckpt_dir=None), key=2)
    a.submit_feedback(fb)
    ref.submit_feedback(fb)
    a.start_learner()
    a.stop_learner(drain=True)
    while ref.step():
        pass
    a.checkpoint()
    del a
    c = AMTLServer.resume(problem, cfg, _w0(problem), prng.key_from_seed(2),
                          sc, device="cpu")
    assert c.event_count == ref.event_count
    t, x = _requests(problem, 6, seed=3)
    assert torch.equal(c.predict(t, x), ref.predict(t, x))
    c.submit_feedback(fb)
    ref.submit_feedback(fb)
    c.start_learner()
    c.stop_learner(drain=True)
    while ref.step():
        pass
    assert torch.equal(c.iterate(), ref.iterate())


# ----------------------------------------------------------- learner lifecycle
def test_cooperative_step_is_fenced_while_learner_runs(problem):
    server = _server(problem, _cfg(problem, "delta"))
    server.start_learner()
    with pytest.raises(RuntimeError, match="owns the chunk loop"):
        server.step()
    with pytest.raises(RuntimeError, match="already running"):
        server.start_learner()
    server.stop_learner()
    assert server.step() == 0
    assert server.stop_learner() == 0


def test_learner_exception_surfaces_on_stop(problem):
    server = _server(problem, _cfg(problem, "delta"))

    def boom(state, offs, n):
        raise RuntimeError("engine exploded")

    server.engine = server.engine._replace(run=boom)
    before = server.serving()
    server.submit_feedback([0, 1, 2])
    server.start_learner()
    with pytest.raises(RuntimeError, match="engine exploded"):
        server.stop_learner(drain=True, timeout=60)
    assert server.serving() is before
    assert not server.learner_running
    t, x = _requests(problem, 3)
    assert server.predict(t, x).shape == (3,)


def test_frozen_server_refuses_learner(problem):
    server = _server(problem, _cfg(problem, "delta"),
                     ServeConfig(chunk_events=4, learning=False))
    with pytest.raises(RuntimeError, match="frozen"):
        server.start_learner()


def test_checkpoint_cadence_preserved_on_learner_thread(problem, tmp_path):
    sc = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path),
                     checkpoint_every=4, keep_last=2)
    server = _server(problem, _cfg(problem, "delta"), sc)
    server.submit_feedback([i % problem.num_tasks for i in range(16)])
    server.start_learner()
    server.stop_learner(drain=True)
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_00000012.npz", "step_00000016.npz"]
    assert all(re.fullmatch(r"step_\d{8}\.npz", f) for f in names)


def test_serve_leaves_chunks_to_running_learner(problem):
    server = _server(problem, _cfg(problem, "delta"))
    t, x = _requests(problem, 4)
    server.start_learner()
    _, receipt, ran = server.serve(t, x, feedback_task_ids=[0, 1])
    assert receipt.accepted == 2 and ran == 0
    server.stop_learner(drain=True)
    assert sum(server.chunk_log) == 2


# ------------------------------------------------------------ SLO admission
def _trace(controller):
    return [(d.sample, d.level_before, d.level, d.chunk_events)
            for d in controller.decisions]


def test_slo_trace_is_pure_function_of_latency_sequence():
    rng = np.random.default_rng(5)
    lat = list(rng.uniform(0.1, 2.0, size=40)) \
        + list(rng.uniform(30.0, 60.0, size=60)) \
        + list(rng.uniform(0.1, 2.0, size=60))
    a = LatencySLOController(10.0, 32, 4, window=20)
    b = LatencySLOController(10.0, 32, 4, window=20)
    theirs = JController(10.0, 32, 4, window=20)
    for v in lat:
        a.record(v)
        b.record(v)
        theirs.record(v)
    assert _trace(a) == _trace(b) == _trace(theirs)
    assert a.snapshot() == theirs.snapshot()
    assert a.violations == sum(v > 10.0 for v in lat)
    level = 0
    for d in a.decisions:
        assert d.level_before == level
        want = min(level + 1, a._max_level) if d.p95_ms > 10.0 \
            else max(level - 1, 0)
        assert d.level == want
        assert d.chunk_events == degraded_budget(32, 4, d.level)
        level = d.level
    assert any(d.level > d.level_before for d in a.decisions)
    assert a.level == 0


def test_degraded_budget_halves_floored_to_events_per_step():
    assert [degraded_budget(32, 4, L) for L in range(5)] == \
        [32, 16, 8, 4, 4]
    assert degraded_budget(8, 8, 3) == 8
    c = LatencySLOController(1.0, 32, 4, window=2)
    for _ in range(40):
        c.record(100.0)
    assert c.level == c._max_level == 3
    assert c.chunk_events == 4
    c.record(0.001)
    c.record(0.001)
    assert c.level == 2 and c.chunk_events == 8


def test_server_degrades_chunk_budget_under_slo_violation(problem):
    sc = ServeConfig(chunk_events=8, slo_ms=1e-6, slo_window=4)
    server = _server(problem, _cfg(problem, "delta"), sc)
    t, x = _requests(problem, 4)
    for _ in range(12):
        server.predict(t, x)
    slo = server.stats()["slo"]
    assert slo["level"] == 3 and slo["chunk_events"] == 1
    assert slo["violations"] == 12
    assert [d["level"] for d in slo["decisions"]] == [1, 2, 3]
    server.submit_feedback([0, 1, 2, 3, 4])
    assert server.step() == 1
    assert server.chunk_log == [1]
    relaxed = _server(problem, _cfg(problem, "delta"),
                      ServeConfig(chunk_events=8, slo_ms=1e6, slo_window=4))
    relaxed.submit_feedback([0, 1, 2, 3, 4])
    assert relaxed.step() == 5


def test_slo_shed_rejects_feedback_while_degraded(problem):
    sc = ServeConfig(chunk_events=8, slo_ms=1e-6, slo_window=2,
                     slo_shed=True)
    server = _server(problem, _cfg(problem, "delta"), sc)
    assert server.submit_feedback([0, 1]).accepted == 2
    t, x = _requests(problem, 4)
    server.predict(t, x)
    server.predict(t, x)
    assert server.stats()["slo"]["level"] == 1
    receipt = server.submit_feedback([0, 1, 2])
    assert receipt == (0, 3) and receipt.reason == "shed"
    assert server.stats()["shed_feedback"] == 3
    assert server.pending_feedback == 2


def test_slo_config_validates(problem):
    with pytest.raises(ValueError, match="slo_shed requires slo_ms"):
        _server(problem, _cfg(problem, "delta"),
                ServeConfig(chunk_events=4, slo_shed=True))
    with pytest.raises(ValueError, match="slo_ms must be > 0"):
        _server(problem, _cfg(problem, "delta"),
                ServeConfig(chunk_events=4, slo_ms=0.0))
    with pytest.raises(ValueError, match="slo_window must be >= 1"):
        _server(problem, _cfg(problem, "delta"),
                ServeConfig(chunk_events=4, slo_ms=5.0, slo_window=0))
