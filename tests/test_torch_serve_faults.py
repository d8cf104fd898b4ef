"""Fault tolerance of the port's learn-while-serve server under
deterministic fault injection (`repro_torch.serve.faults.FaultPlan`), the
contracts of tests/test_serve_faults.py on the port:

  * supervised learner: a scripted crash is healed by one restart and the
    final state is bitwise ONE `engine.run` over the surviving chunk log;
    a spent restart budget latches the breaker (frozen serving, reason
    "breaker", the terminal exception once on stop);
  * non-finite guard: NaN feedback dies at admission (the session is
    bitwise the one where those rows were never sent); a poisoned
    iterate is quarantined, its fold rolled back bitwise, and never
    reaches a checkpoint;
  * resume: a corrupt newest record falls back one interval, an
    all-corrupt directory is refused, a torn store record drops to the
    older one, and the checkpoint's crash-split window resumes.

The learner tests queue their feedback before the learner starts, or wait
on a condition the learner must reach: their assertions do not depend on
the threads' timing.
"""
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch as rt  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.checkpoint import CheckpointCorruptError  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.interop import state_to_numpy  # noqa: E402
from repro_torch.serve import (AMTLServer, BackgroundLearner,  # noqa: E402
                               FaultPlan, InjectedFault, ServeConfig,
                               corrupt_leaf, truncate_record)

ENGINES = ("dense", "delta", "batch")
RAGGED_ENGINES = ("delta", "batch")


@pytest.fixture(scope="module")
def problem(small_problem):
    return rt.problem_from_numpy(np.asarray(small_problem.xs),
                                 np.asarray(small_problem.ys), "lstsq",
                                 "nuclear", 0.1, device="cpu")


def _cfg(problem, engine, tau=3, **kw):
    if engine == "batch":
        kw.setdefault("event_batch", 4)
        kw.setdefault("prox_every", kw["event_batch"])
    return rt.AMTLConfig(eta=1.0 / problem.lipschitz(), eta_k=0.7, tau=tau,
                         engine=engine, **kw)


def _w0(problem):
    return np.zeros((problem.dim, problem.num_tasks), np.float32)


def _server(problem, cfg, serve_cfg=ServeConfig(chunk_events=4), key=0,
            fault_plan=None):
    return AMTLServer(problem, cfg, _w0(problem), prng.key_from_seed(key),
                      serve_cfg, device="cpu", fault_plan=fault_plan)


def _resume(problem, cfg, serve_cfg):
    return AMTLServer.resume(problem, cfg, _w0(problem),
                             prng.key_from_seed(0), serve_cfg, device="cpu")


def _rows(problem, k, seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, problem.num_tasks, size=k)
    x = (rng.standard_normal((k, problem.dim))
         / np.sqrt(problem.dim)).astype(np.float32)
    y = rng.standard_normal(k).astype(np.float32)
    return t, x, y


def _wait(predicate, timeout_s=120.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def _plain_iterate(problem, cfg, n):
    eng = rt.make_engine(problem, cfg, device="cpu")
    return eng.iterate(eng.run(eng.init(_w0(problem), prng.key_from_seed(0)),
                               None, n))


# --------------------------------------------------- supervised learner --
def test_supervised_restart_replays_surviving_chunk_log(problem):
    cfg = _cfg(problem, "batch")
    serve_cfg = ServeConfig(chunk_events=4, restart_limit=2,
                            restart_backoff_s=0.01)
    server = _server(problem, cfg, serve_cfg,
                     fault_plan=FaultPlan(crash_on_chunks={1}))
    for _ in range(4):
        server.submit_feedback(np.arange(4) % problem.num_tasks)
    server.start_learner()
    assert _wait(lambda: server.stats()["health"]["learner_restarts"] >= 1
                 and len(server.chunk_log) >= 3)
    learned = server.stop_learner(drain=True, timeout=60)
    health = server.stats()["health"]
    assert health["learner_restarts"] == 1
    assert health["learner_crashes"] == 1
    assert len(health["crash_log"]) == 1
    assert "InjectedFault" in health["crash_log"][0]
    assert len(health["recovery_ms"]) == 1 and health["recovery_ms"][0] > 0
    assert server.chunk_log == [4, 4, 4]       # chunk 1 lost to the crash
    assert learned == sum(server.chunk_log)
    assert torch.equal(server.iterate(), _plain_iterate(problem, cfg, 12))


def test_supervised_no_faults_is_bitwise_plain_learner(problem):
    cfg = _cfg(problem, "delta")
    fb = [np.arange(4) % problem.num_tasks for _ in range(3)]
    sup = _server(problem, cfg, ServeConfig(chunk_events=4, restart_limit=3))
    coop = _server(problem, cfg)
    for t in fb:
        sup.submit_feedback(t)
        coop.submit_feedback(t)
    sup.start_learner()
    sup.stop_learner(drain=True, timeout=60)
    while coop.step():
        pass
    assert sup.chunk_log == coop.chunk_log
    assert torch.equal(sup.iterate(), coop.iterate())
    health = sup.stats()["health"]
    assert health["learner_crashes"] == 0
    assert not health["breaker_tripped"]


def test_breaker_latches_frozen_serving(problem):
    cfg = _cfg(problem, "batch")
    serve_cfg = ServeConfig(chunk_events=4, restart_limit=1,
                            restart_backoff_s=0.01)
    server = _server(problem, cfg, serve_cfg,
                     fault_plan=FaultPlan(crash_on_chunks=set(range(64))))
    before = server.serving()
    server.start_learner()
    server.submit_feedback([0, 1, 2, 3])

    def _feed_until_tripped():
        if not server.breaker_tripped:
            server.submit_feedback([0, 1, 2, 3])
        return server.breaker_tripped
    assert _wait(_feed_until_tripped)
    assert _wait(lambda: not server.learner_running)
    x = np.random.default_rng(0).standard_normal(
        (3, problem.dim)).astype(np.float32)
    assert server.predict([0, 1, 2], x).shape == (3,)
    assert server.serving() is before
    receipt = server.submit_feedback([0, 1])
    assert receipt == (0, 2) and receipt.reason == "breaker"
    assert server.step() == 0
    health = server.stats()["health"]
    assert health["breaker_tripped"]
    assert health["breaker_rejected"] >= 2
    assert health["learner_restarts"] == 1
    assert health["learner_crashes"] == 2
    with pytest.raises(InjectedFault):
        server.stop_learner(drain=False, timeout=60)
    assert server.stop_learner(drain=False, timeout=60) == 0
    with pytest.raises(RuntimeError, match="circuit breaker"):
        server.start_learner()


# --------------------------------------------------- non-finite guard ----
def test_nonfinite_feedback_rejected_at_admission(problem):
    server = _server(problem, _cfg(problem, "batch"))
    t, x, y = _rows(problem, 6, seed=1)
    x[2, 5] = np.inf
    y[4] = np.nan
    receipt = server.submit_feedback(t, x, y)
    assert receipt == (4, 2) and receipt.reason == "nonfinite"
    assert server.stats()["health"]["nonfinite_feedback"] == 2
    assert server.pending_feedback == 4
    server.step()
    assert bool(torch.isfinite(server.iterate()).all())


def test_nan_quarantine_is_bitwise_never_submitted(problem):
    cfg = _cfg(problem, "batch")
    t, x, y = _rows(problem, 12, seed=2)
    poisoned = _server(problem, cfg,
                       fault_plan=FaultPlan(nan_feedback=[(0, 3), (1, 0)]))
    clean = _server(problem, cfg)
    for lo in (0, 4, 8):
        rp = poisoned.submit_feedback(t[lo:lo + 4], x[lo:lo + 4],
                                      y[lo:lo + 4])
        keep = np.ones(4, bool)
        if lo == 0:
            keep[3] = False
        if lo == 4:
            keep[0] = False
        rc = clean.submit_feedback(t[lo:lo + 4][keep], x[lo:lo + 4][keep],
                                   y[lo:lo + 4][keep])
        assert rp.accepted == rc.accepted
    while poisoned.step():
        pass
    while clean.step():
        pass
    assert poisoned.chunk_log == clean.chunk_log
    assert torch.equal(poisoned.iterate(), clean.iterate())
    assert poisoned.store_rows == clean.store_rows
    for a, b in zip(poisoned._store.state(), clean._store.state(),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    assert poisoned.stats()["health"]["nonfinite_feedback"] == 2


def test_poisoned_iterate_quarantined_with_rollback(problem):
    cfg = _cfg(problem, "batch")
    server = _server(problem, cfg,
                     fault_plan=FaultPlan(poison_iterate_on_chunks={1}))
    t0, x0, y0 = _rows(problem, 4, seed=3)
    server.submit_feedback(t0, x0, y0)
    assert server.step() == 4
    committed = server.serving()
    store_snapshot = server._store.state()
    cap_before = server._store.capacity
    problem_before, engine_before = server.problem, server.engine

    k = server._store.capacity + 2           # forces a doubling at the fold
    rng = np.random.default_rng(4)
    x1 = (rng.standard_normal((k, problem.dim))
          / np.sqrt(problem.dim)).astype(np.float32)
    y1 = rng.standard_normal(k).astype(np.float32)
    server.submit_feedback(np.zeros(k, np.int64), x1, y1)
    consumed = server.step()
    assert consumed > 0
    assert server.chunk_log == [4]
    assert server.serving() is committed
    assert bool(torch.isfinite(server.iterate()).all())
    assert server._store.capacity == cap_before
    for a, b in zip(server._store.state(), store_snapshot, strict=True):
        np.testing.assert_array_equal(a, b)
    assert server.problem is problem_before
    assert server.engine is engine_before
    health = server.stats()["health"]
    assert health["nonfinite_chunks"] == 1
    assert health["quarantined_feedback"] == consumed
    assert health["quarantine_log"] == [{0: consumed}]

    t2, x2, y2 = _rows(problem, 4, seed=5)
    server.submit_feedback(t2, x2, y2)
    assert server.step() == 4
    assert server.chunk_log == [4, 4]
    replay = _server(problem, cfg)
    replay.submit_feedback(t0, x0, y0)
    replay.step()
    replay.submit_feedback(t2, x2, y2)
    replay.step()
    assert torch.equal(server.iterate(), replay.iterate())


def test_poisoned_chunk_never_reaches_checkpoint(problem, tmp_path):
    cfg = _cfg(problem, "batch")
    serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path),
                            checkpoint_every=4)
    server = _server(problem, cfg, serve_cfg,
                     fault_plan=FaultPlan(poison_iterate_on_chunks={1}))
    for seed in range(3):
        server.submit_feedback(*_rows(problem, 4, seed=seed))
        server.step()
    assert server.stats()["health"]["nonfinite_chunks"] == 1
    steps = checkpoint.record_steps(str(tmp_path))
    assert steps == [8, 4]
    like = server.engine.init(_w0(problem), prng.key_from_seed(0))
    for s in steps:
        state = checkpoint.restore(str(tmp_path), s, like=like)
        for leaf in state_to_numpy(state):
            if np.issubdtype(leaf.dtype, np.floating):
                assert np.isfinite(leaf).all()


def test_fault_plan_poison_is_a_nan_tensor():
    plan = FaultPlan(poison_iterate_on_chunks={1})
    v = torch.ones(3, 2)
    assert plan.poison(0, v) is v
    out = plan.poison(1, v)
    assert out.shape == v.shape and out.dtype == v.dtype
    assert bool(torch.isnan(out).all())


# ------------------------------------------------------- resume paths ----
@pytest.mark.parametrize("engine", ENGINES)
def test_corrupt_newest_checkpoint_falls_back_one_interval(problem, engine,
                                                           tmp_path):
    cfg = _cfg(problem, engine)
    serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path))
    server = _server(problem, cfg, serve_cfg)
    server.submit_feedback([0, 1, 2, 3])
    server.step()
    server.checkpoint()                       # step 4: the fallback
    server.submit_feedback([1, 2, 3, 4])
    server.step()
    server.checkpoint()                       # step 8: about to rot
    corrupt_leaf(os.path.join(str(tmp_path), "step_00000008.npz"))
    resumed = _resume(problem, cfg, serve_cfg)
    assert resumed.event_count == 4
    reference = _server(problem, cfg)
    reference.submit_feedback([0, 1, 2, 3])
    reference.step()
    assert torch.equal(resumed.iterate(), reference.iterate())
    t = np.arange(6) % problem.num_tasks
    x = np.random.default_rng(9).standard_normal(
        (6, problem.dim)).astype(np.float32)
    assert torch.equal(resumed.predict(t, x), reference.predict(t, x))
    resumed.submit_feedback([0, 1, 2, 3])
    reference.submit_feedback([0, 1, 2, 3])
    assert resumed.step() == reference.step() == 4
    assert torch.equal(resumed.iterate(), reference.iterate())


def test_resume_refuses_all_corrupt_directory(problem, tmp_path):
    cfg = _cfg(problem, "delta")
    serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path))
    server = _server(problem, cfg, serve_cfg)
    server.submit_feedback([0, 1, 2, 3])
    server.step()
    server.checkpoint()
    truncate_record(os.path.join(str(tmp_path), "step_00000004.npz"))
    with pytest.raises(CheckpointCorruptError):
        _resume(problem, cfg, serve_cfg)


@pytest.mark.parametrize("engine", RAGGED_ENGINES)
def test_resume_drops_to_older_store_record_on_corruption(problem, engine,
                                                          tmp_path):
    cfg = _cfg(problem, engine)
    serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path))
    server = _server(problem, cfg, serve_cfg)
    server.submit_feedback(*_rows(problem, 4, seed=6))
    server.step()
    server.checkpoint()                         # store + engine at 4
    rows_at_4 = server.store_rows
    server.submit_feedback(*_rows(problem, 4, seed=7))
    server.step()
    server.checkpoint()                         # store + engine at 8
    truncate_record(os.path.join(str(tmp_path), "store",
                                 "step_00000008.npz"))
    resumed = _resume(problem, cfg, serve_cfg)
    assert resumed.event_count == 8
    assert resumed.store_rows == rows_at_4


def test_resume_refuses_when_every_store_record_is_corrupt(problem,
                                                            tmp_path):
    cfg = _cfg(problem, "delta")
    serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path))
    server = _server(problem, cfg, serve_cfg)
    server.submit_feedback(*_rows(problem, 4, seed=6))
    server.step()
    server.checkpoint()
    truncate_record(os.path.join(str(tmp_path), "store",
                                 "step_00000004.npz"))
    with pytest.raises(CheckpointCorruptError, match="every store record"):
        _resume(problem, cfg, serve_cfg)


def test_checkpoint_crash_split_window_resumes(problem, tmp_path):
    cfg = _cfg(problem, "batch")
    serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path))
    server = _server(problem, cfg, serve_cfg,
                     fault_plan=FaultPlan(fail_checkpoint_calls={1}))
    server.submit_feedback(*_rows(problem, 4, seed=8))
    server.step()
    server.checkpoint()                       # call 0: store 4 + engine 4
    rows_after_first_fold = server.store_rows
    server.submit_feedback(*_rows(problem, 4, seed=9))
    server.step()
    rows_after_second_fold = server.store_rows
    with pytest.raises(InjectedFault):
        server.checkpoint()                   # call 1: store 8, no engine
    assert checkpoint.record_steps(str(tmp_path)) == [4]
    assert checkpoint.record_steps(
        os.path.join(str(tmp_path), "store")) == [8, 4]
    resumed = _resume(problem, cfg, serve_cfg)
    assert resumed.event_count == 4
    assert resumed.store_rows == rows_after_first_fold
    os.remove(os.path.join(str(tmp_path), "store", "step_00000004.npz"))
    resumed = _resume(problem, cfg, serve_cfg)
    assert resumed.event_count == 4
    assert resumed.store_rows == rows_after_second_fold


# ------------------------------------------ learner join regression ------
def test_learner_join_timeout_retries_and_surfaces_once():
    gate = threading.Event()

    class _FakeServer:
        def _step_once(self):
            gate.wait()
            raise RuntimeError("boom after the gate")

    learner = BackgroundLearner(_FakeServer())
    learner.start()
    with pytest.raises(TimeoutError, match="retry stop"):
        learner.stop(drain=False, timeout=0.05)
    assert learner.running
    gate.set()
    with pytest.raises(RuntimeError, match="boom after the gate"):
        learner.stop(drain=False, timeout=60)
    assert learner.stop(drain=False, timeout=60) == 0
    assert not learner.running

    class _CleanServer:
        def _step_once(self):
            return 0
    learner2 = BackgroundLearner(_CleanServer())
    learner2.start()
    assert learner2.stop(drain=False, timeout=60) == 0


def test_fault_plan_counters_are_deterministic(problem):
    cfg = _cfg(problem, "batch")
    logs = []
    for _ in range(2):
        server = _server(problem, cfg,
                         fault_plan=FaultPlan(poison_iterate_on_chunks={0}))
        server.submit_feedback([0, 1, 2, 3])
        server.step()
        server.submit_feedback([0, 1, 2, 3])
        server.step()
        logs.append((list(server.chunk_log),
                     server.stats()["health"]["quarantine_log"]))
    assert logs[0] == logs[1]
    assert logs[0][0] == [4]


def test_serve_config_validates_restart_knobs(problem):
    with pytest.raises(ValueError, match="restart_limit"):
        _server(problem, _cfg(problem, "batch"),
                ServeConfig(chunk_events=4, restart_limit=-1))
    with pytest.raises(ValueError, match="restart_backoff_s"):
        _server(problem, _cfg(problem, "batch"),
                ServeConfig(chunk_events=4, restart_backoff_s=-0.5))
