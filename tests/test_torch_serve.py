"""The port's learn-while-serve server (`repro_torch.serve.AMTLServer`) on
the CPU: the contracts of tests/test_serve.py and the serving half of
tests/test_taskstore.py on the port's own engines, and one server-level
parity test against `repro.serve`.

  * frozen serving is bitwise `engine.iterate(engine.init(...))`;
  * feedback-driven serving (label-free and labeled) is bitwise one
    `engine.run` over the chunk log, with the same folds at the same
    boundaries;
  * a checkpoint restart is invisible to later predictions;
  * admission, quota, coalescing, predict and config surfaces.

Everything is driven through the cooperative `step()`: no test here
depends on timing.  Against JAX, the same submission script gives equal
chunk logs, receipts and counters; the served iterate within SERVE_RTOL
of its scale and the predictions within SERVE_RTOL of sum_i |x_i||v_i|
(float32 products summed in another order, ROADMAP's engine tolerance).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import AMTLConfig as JConfig  # noqa: E402
from repro.serve import AMTLServer as JServer  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import TaskStore  # noqa: E402
from repro_torch.interop import state_to_numpy  # noqa: E402
from repro_torch.launch.mesh import TaskMesh  # noqa: E402
from repro_torch.serve import AMTLServer, ServeConfig  # noqa: E402
import repro_torch.serve.server as srv_mod  # noqa: E402

ENGINES = ("dense", "delta", "batch", "sharded")
SERVE_RTOL = 1e-4


@pytest.fixture(scope="module")
def problem(small_problem):
    return rt.problem_from_numpy(np.asarray(small_problem.xs),
                                 np.asarray(small_problem.ys), "lstsq",
                                 "nuclear", 0.1, device="cpu")


def _cfg(problem, engine, tau=3, **kw):
    if engine in ("batch", "sharded"):
        kw.setdefault("event_batch", 4)
        kw.setdefault("prox_every", kw["event_batch"])
    return rt.AMTLConfig(eta=1.0 / problem.lipschitz(), eta_k=0.7, tau=tau,
                         engine=engine, **kw)


def _w0(problem):
    return np.zeros((problem.dim, problem.num_tasks), np.float32)


def _server(problem, cfg, serve_cfg=ServeConfig(chunk_events=4), key=0,
            **kw):
    return AMTLServer(problem, cfg, _w0(problem), prng.key_from_seed(key),
                      serve_cfg, device="cpu", **kw)


def _resume(problem, cfg, serve_cfg, key=0):
    return AMTLServer.resume(problem, cfg, _w0(problem),
                             prng.key_from_seed(key), serve_cfg,
                             device="cpu")


def _engine(problem, cfg):
    return rt.make_engine(problem, cfg, device="cpu")


def _init(eng, problem, key=0):
    return eng.init(_w0(problem), prng.key_from_seed(key))


def _requests(problem, n, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, problem.num_tasks, size=n)
    x = rng.standard_normal((n, problem.dim)).astype(np.float32)
    return t, x


def _labeled_batch(problem, k, rng):
    t = rng.integers(0, problem.num_tasks, size=k)
    x = rng.standard_normal((k, problem.dim)).astype(np.float32)
    y = rng.standard_normal(k).astype(np.float32)
    return t, x, y


def _assert_states_equal(a, b, msg=""):
    for la, lb in zip(state_to_numpy(a), state_to_numpy(b), strict=True):
        np.testing.assert_array_equal(la, lb, err_msg=msg)


# ------------------------------------------------------------- frozen path
@pytest.mark.parametrize("engine", ENGINES)
def test_frozen_serving_is_bitwise_frozen_engine(problem, engine):
    cfg = _cfg(problem, engine)
    server = _server(problem, cfg, ServeConfig(chunk_events=4,
                                               learning=False))
    eng = _engine(problem, cfg)
    frozen = eng.iterate(_init(eng, problem))
    assert torch.equal(server.iterate(), frozen)
    t, x = _requests(problem, 7)
    preds, receipt, ran = server.serve(t, x, feedback_task_ids=t)
    assert ran == 0 and receipt == (0, 7) and receipt.reason == "frozen"
    want = np.einsum("bd,bd->b", x, frozen.numpy()[:, t].T)
    np.testing.assert_allclose(preds.numpy(), want, rtol=1e-6)
    assert torch.equal(server.iterate(), frozen)


def test_zero_feedback_learning_server_is_also_frozen(problem):
    server = _server(problem, _cfg(problem, "batch"))
    before = server.iterate().clone()
    t, x = _requests(problem, 5)
    for _ in range(3):
        server.predict(t, x)
        assert server.step() == 0
    assert torch.equal(server.iterate(), before)
    assert server.chunk_log == []


# -------------------------------------------------------- feedback replay
@pytest.mark.parametrize("engine", ENGINES)
def test_feedback_serving_replays_plain_run_bitwise(problem, engine):
    cfg = _cfg(problem, engine)
    per = 4 if engine in ("batch", "sharded") else 1
    server = _server(problem, cfg, ServeConfig(chunk_events=2 * per))
    rng = np.random.default_rng(3)
    t, x = _requests(problem, 6)
    for _ in range(5):
        fb = rng.integers(0, problem.num_tasks,
                          size=rng.integers(1, 3 * per))
        server.serve(t, x, feedback_task_ids=fb)
    assert sum(server.chunk_log) > 0
    for n in server.chunk_log:
        assert n % per == 0 and 0 < n <= 2 * per
    eng = _engine(problem, cfg)
    state = eng.run(_init(eng, problem), None, sum(server.chunk_log))
    assert torch.equal(server.iterate(), eng.iterate(state))
    _assert_states_equal(server._state, state, engine)


def test_serving_buffer_swaps_only_at_chunk_boundaries(problem):
    server = _server(problem, _cfg(problem, "delta"))
    t, x = _requests(problem, 4)
    before = server.predict(t, x)
    preds, _, ran = server.serve(t, x, feedback_task_ids=[0, 1, 2, 3])
    assert ran == 4
    assert torch.equal(preds, before)
    assert not torch.equal(server.predict(t, x), before)


# --------------------------------------------------- checkpoint / restart
@pytest.mark.parametrize("engine", ENGINES)
def test_restart_is_invisible_to_predictions(problem, engine, tmp_path):
    cfg = _cfg(problem, engine)
    per = 4 if engine in ("batch", "sharded") else 1
    serve_cfg = ServeConfig(chunk_events=2 * per, ckpt_dir=str(tmp_path),
                            checkpoint_every=2 * per, keep_last=2)
    a = _server(problem, cfg, serve_cfg, key=1)
    b = _server(problem, cfg, serve_cfg._replace(ckpt_dir=None,
                                                 checkpoint_every=None),
                key=1)
    t, x = _requests(problem, 5, seed=9)
    fb = [i % problem.num_tasks for i in range(2 * per)]
    a.serve(t, x, feedback_task_ids=fb)     # chunk + auto-checkpoint
    b.serve(t, x, feedback_task_ids=fb)
    del a
    c = _resume(problem, cfg, serve_cfg, key=1)
    assert c.event_count == 2 * per
    assert torch.equal(c.iterate(), b.iterate())
    for _ in range(3):
        pc, _, rc = c.serve(t, x, feedback_task_ids=fb)
        pb, _, rb = b.serve(t, x, feedback_task_ids=fb)
        assert rc == rb
        assert torch.equal(pc, pb)
    _assert_states_equal(c._state, b._state, engine)


def test_checkpoint_rotation_on_disk(problem, tmp_path):
    serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path),
                            checkpoint_every=4, keep_last=2)
    server = _server(problem, _cfg(problem, "batch"), serve_cfg)
    t, x = _requests(problem, 3)
    for _ in range(5):
        server.serve(t, x, feedback_task_ids=[0, 1, 2, 3])
    assert sorted(os.listdir(tmp_path)) == ["step_00000016.npz",
                                            "step_00000020.npz"]


def test_resume_with_empty_dir_is_fresh_init(problem, tmp_path):
    server = _resume(problem, _cfg(problem, "delta"),
                     ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path)))
    assert server.event_count == 0


def test_resume_restores_mixed_padding_checkpoint(problem, tmp_path):
    serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path))
    server = _server(problem, _cfg(problem, "delta"), serve_cfg)
    server.submit_feedback([0, 1, 2, 3])
    server.step()
    server.checkpoint()
    os.rename(tmp_path / "step_00000004.npz", tmp_path / "step_4.npz")
    want = server.iterate().clone()
    del server
    resumed = _resume(problem, _cfg(problem, "delta"), serve_cfg)
    assert resumed.event_count == 4
    assert torch.equal(resumed.iterate(), want)


def test_resume_builds_init_state_once(problem, tmp_path, monkeypatch):
    serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path))
    server = _server(problem, _cfg(problem, "delta"), serve_cfg)
    server.submit_feedback([0, 1, 2])
    server.step()
    server.checkpoint()
    del server
    init_calls = []
    real_make_engine = srv_mod.make_engine

    def spying_make_engine(problem, cfg, device=None):
        eng = real_make_engine(problem, cfg, device)
        real_init = eng.init

        def counted_init(v0, key):
            init_calls.append(1)
            return real_init(v0, key)
        return eng._replace(init=counted_init)

    monkeypatch.setattr(srv_mod, "make_engine", spying_make_engine)
    resumed = _resume(problem, _cfg(problem, "delta"), serve_cfg)
    assert len(init_calls) == 1
    assert resumed.event_count == 3


# ------------------------------------------------------- admission / QoS
def test_admission_cap_rejects_burst(problem):
    server = _server(problem, _cfg(problem, "delta"),
                     ServeConfig(chunk_events=4, max_pending_per_task=3))
    receipt = server.submit_feedback([0] * 10)
    assert receipt == (3, 7) and receipt.reason == "admission"
    assert server.pending_feedback == 3
    assert server.stats()["rejected_feedback"] == 7


def test_chunk_quota_stops_bursty_task_starving_budget(problem):
    server = _server(problem, _cfg(problem, "delta"),
                     ServeConfig(chunk_events=6, task_chunk_quota=2))
    server.submit_feedback([0] * 50)
    server.submit_feedback([1, 2, 3, 4])
    assert server.step() == 6
    assert server._pending[0] == 48
    assert server._pending[1:].sum() == 0
    assert server.step() == 2
    assert server._pending[0] == 46


def test_coalesce_floors_to_events_per_step(problem):
    server = _server(problem, _cfg(problem, "batch"),
                     ServeConfig(chunk_events=8))
    server.submit_feedback([0, 1, 2, 3, 4, 0])      # 6 items, per = 4
    assert server.step() == 4
    assert server.pending_feedback == 2
    server.submit_feedback([1, 2])
    assert server.step() == 4
    assert server.pending_feedback == 0


# ------------------------------------------------------- predict surface
@pytest.mark.parametrize("loss_name", ("lstsq", "logistic"))
def test_predict_empty_batch_returns_empty_scores(problem, loss_name):
    prob = problem._replace(loss_name=loss_name)
    server = _server(prob, _cfg(prob, "delta"))
    out = server.predict([], np.zeros((0, prob.dim), np.float32))
    assert out.shape == (0,) and out.dtype == torch.float32
    assert server.stats()["requests"] == 1
    assert server.stats()["predictions"] == 0
    t, x = _requests(prob, 3)
    assert server.predict(t, x).shape == (3,)


def test_predict_micro_batches_pad_and_slice(problem):
    server = _server(problem, _cfg(problem, "delta"),
                     ServeConfig(chunk_events=4, max_batch=4))
    server.submit_feedback([0, 1, 2])
    server.step()
    t, x = _requests(problem, 11, seed=4)
    got = server.predict(t, x).numpy()
    assert got.shape == (11,)
    v = server.iterate().numpy()
    np.testing.assert_allclose(got, np.einsum("bd,bd->b", x, v[:, t].T),
                               rtol=1e-6)
    np.testing.assert_allclose(server.predict(t[:1], x[:1]).numpy(),
                               got[:1], rtol=1e-6)


def test_predict_pads_to_the_bucket(problem, monkeypatch):
    """Each slice is padded to the next power of two, at most max_batch."""
    server = _server(problem, _cfg(problem, "delta"),
                     ServeConfig(chunk_events=4, max_batch=8))
    seen = []
    real = srv_mod._predict_scores

    def spy(v, task_ids, x, loss_name):
        seen.append(tuple(x.shape))
        return real(v, task_ids, x, loss_name)

    monkeypatch.setattr(srv_mod, "_predict_scores", spy)
    t, x = _requests(problem, 11)
    server.predict(t, x)
    server.predict(t[:3], x[:3])
    assert seen == [(8, problem.dim), (4, problem.dim), (4, problem.dim)]
    assert [srv_mod._bucket(n, 8) for n in (1, 2, 3, 5, 9)] == \
        [1, 2, 4, 8, 8]


def test_logistic_predictions_are_probabilities(problem):
    logit = problem._replace(loss_name="logistic")
    server = _server(logit, _cfg(logit, "delta"))
    t, x = _requests(logit, 6)
    p = server.predict(t, x).numpy()
    assert ((p > 0) & (p < 1)).all()


def test_predict_validates_inputs(problem):
    server = _server(problem, _cfg(problem, "delta"))
    with pytest.raises(ValueError, match="features must be"):
        server.predict([0, 1], np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="task_ids must be in"):
        server.predict([problem.num_tasks],
                       np.zeros((1, problem.dim), np.float32))
    with pytest.raises(ValueError, match="feedback task_ids"):
        server.submit_feedback([-1])


def test_serve_config_validates(problem):
    with pytest.raises(ValueError, match="multiple of the engine's"):
        _server(problem, _cfg(problem, "batch"), ServeConfig(chunk_events=6))
    with pytest.raises(ValueError, match="task_chunk_quota"):
        _server(problem, _cfg(problem, "delta"),
                ServeConfig(chunk_events=4, task_chunk_quota=0))
    with pytest.raises(ValueError, match="max_pending_per_task"):
        _server(problem, _cfg(problem, "delta"),
                ServeConfig(chunk_events=4, max_pending_per_task=0))
    with pytest.raises(ValueError, match="nowhere to write"):
        _server(problem, _cfg(problem, "delta"),
                ServeConfig(chunk_events=4, checkpoint_every=4))
    with pytest.raises(ValueError, match="max_batch"):
        _server(problem, _cfg(problem, "delta"),
                ServeConfig(chunk_events=4, max_batch=0))
    sharded = _cfg(problem, "delta")._replace(engine="sharded")
    server = _server(problem, sharded)
    assert server.mesh.size == 1
    assert torch.equal(server.iterate(), torch.zeros(problem.dim,
                                                     problem.num_tasks))
    two = TaskMesh(None, 0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _server(problem, sharded, mesh=two)


def test_stats_telemetry(problem):
    server = _server(problem, _cfg(problem, "delta"))
    t, x = _requests(problem, 3)
    server.serve(t, x, feedback_task_ids=[0, 1])
    s = server.stats()
    assert s["requests"] == 1 and s["predictions"] == 3
    assert s["events"] == 2 and s["chunks"] == 1
    assert s["learning"] is True
    assert set(s) == {"requests", "predictions", "events", "chunks",
                      "pending_feedback", "pending_rows", "store_rows",
                      "rejected_feedback", "shed_feedback", "learning",
                      "learner_running", "learner_chunks", "slo", "health"}
    assert set(s["health"]) == {
        "learner_restarts", "learner_crashes", "crash_log", "recovery_ms",
        "breaker_tripped", "breaker_rejected", "nonfinite_feedback",
        "nonfinite_chunks", "quarantined_feedback", "quarantine_log"}


# ------------------------------------------------- labeled feedback (store)
@pytest.mark.parametrize("engine", ("delta", "batch", "sharded"))
def test_labeled_feedback_replays_fold_run_sequence_bitwise(problem, engine):
    """After a mix of labeled and label-free feedback the state is bitwise
    the replay: fold the same rows at the same boundaries, rebuild, run,
    over ONE engine session against a replayed TaskStore."""
    cfg = _cfg(problem, engine)
    per = 4 if engine in ("batch", "sharded") else 1
    server = _server(problem, cfg, ServeConfig(chunk_events=2 * per))
    rng = np.random.default_rng(16)
    log = []                               # (rows | None, chunk size)
    for i in range(6):
        if i % 2 == 0:
            t, x, y = _labeled_batch(problem, 2 * per, rng)
            assert server.submit_feedback(t, x, y).accepted == 2 * per
            rows = (t, x, y)
        else:
            server.submit_feedback(
                rng.integers(0, problem.num_tasks, size=2 * per))
            rows = None
        log.append((rows, server.step()))
    n0 = problem.num_tasks * problem.xs.shape[1]
    assert server.store_rows == n0 + 3 * 2 * per

    store = TaskStore.from_problem(problem)
    prob = problem
    eng = _engine(prob, cfg)
    st = _init(eng, prob)
    for rows, n in log:
        if rows is not None:
            store.append(*rows)
            prob = store.problem("cpu")
            eng = _engine(prob, cfg)
        if n:
            st = eng.run(st, None, n)
    assert torch.equal(server.iterate(), eng.iterate(st))
    _assert_states_equal(server._state, st, engine)
    for a, b in zip(server._store.state(), store.state(), strict=True):
        np.testing.assert_array_equal(a, b)


def test_label_free_path_never_creates_store(problem):
    cfg = _cfg(problem, "delta")
    server = _server(problem, cfg)
    prob_obj, eng_obj = server.problem, server.engine
    rng = np.random.default_rng(17)
    for _ in range(4):
        server.submit_feedback(rng.integers(0, problem.num_tasks, size=5))
        server.step()
    assert server._store is None and server.store_rows is None
    assert server.problem is prob_obj and server.engine is eng_obj
    eng = _engine(problem, cfg)
    st = eng.run(_init(eng, problem), None, sum(server.chunk_log))
    _assert_states_equal(server._state, st)


def test_submit_feedback_validates_rows(problem):
    server = _server(problem, _cfg(problem, "delta"))
    with pytest.raises(ValueError, match="given together"):
        server.submit_feedback([0], features=np.zeros((1, problem.dim),
                                                      np.float32))
    with pytest.raises(ValueError, match="given together"):
        server.submit_feedback([0], labels=[1.0])
    with pytest.raises(ValueError, match="features must be"):
        server.submit_feedback([0, 1], np.zeros((2, 3), np.float32),
                               [0.0, 1.0])
    dense = _server(problem, _cfg(problem, "dense"))
    with pytest.raises(ValueError, match="dense"):
        dense.submit_feedback([0], np.zeros((1, problem.dim), np.float32),
                              [0.0])


def test_rejected_items_drop_their_rows(problem):
    server = _server(problem, _cfg(problem, "delta"),
                     ServeConfig(chunk_events=4, max_pending_per_task=3))
    rng = np.random.default_rng(18)
    x = rng.standard_normal((10, problem.dim)).astype(np.float32)
    y = rng.standard_normal(10).astype(np.float32)
    assert server.submit_feedback([0] * 10, x, y) == (3, 7)
    assert server.stats()["pending_rows"] == 3
    server.step()
    n = problem.xs.shape[1]
    assert server._store.row_counts[0] == n + 3
    np.testing.assert_array_equal(
        server._store.problem("cpu").xs[0, n:n + 3].numpy(), x[:3])


def test_feedback_rows_change_future_predictions(problem):
    cfg = _cfg(problem, "delta")
    a = _server(problem, cfg)
    b = _server(problem, cfg)
    rng = np.random.default_rng(19)
    t, x, y = _labeled_batch(problem, 4, rng)
    a.submit_feedback(t, 5.0 * x, 5.0 * y)
    b.submit_feedback(t)
    a.step()
    b.step()
    assert not torch.equal(a.predict(t[:3], x[:3]), b.predict(t[:3], x[:3]))


def test_resume_with_store_is_bitwise_invisible(problem, tmp_path):
    cfg = _cfg(problem, "delta")
    serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path),
                            keep_last=2)
    a = _server(problem, cfg, serve_cfg, key=1)
    b = _server(problem, cfg, serve_cfg._replace(ckpt_dir=None), key=1)
    n0 = problem.xs.shape[1]
    for srv in (a, b):
        rng = np.random.default_rng(20)
        for _ in range(4):
            t = np.zeros(17, np.int64)  # 68 rows on one task: two doublings
            x = rng.standard_normal((17, problem.dim)).astype(np.float32)
            y = rng.standard_normal(17).astype(np.float32)
            srv.submit_feedback(t, x, y)
            while srv.step():
                pass
    assert a._store.capacity == 4 * n0
    a.checkpoint()
    del a
    c = _resume(problem, cfg, serve_cfg, key=1)
    assert c._store is not None and c._store.capacity == 4 * n0
    np.testing.assert_array_equal(c._store.row_counts, b._store.row_counts)
    for srv in (c, b):
        t, x, y = _labeled_batch(problem, 4, np.random.default_rng(21))
        srv.submit_feedback(t, x, y)
        while srv.step():
            pass
    _assert_states_equal(c._state, b._state)
    q = np.random.default_rng(22).standard_normal(
        (5, problem.dim)).astype(np.float32)
    assert torch.equal(c.predict([0, 1, 2, 3, 4], q),
                       b.predict([0, 1, 2, 3, 4], q))


def test_store_checkpoints_pair_with_engine_records(problem, tmp_path):
    serve_cfg = ServeConfig(chunk_events=4, ckpt_dir=str(tmp_path),
                            checkpoint_every=4, keep_last=2)
    server = _server(problem, _cfg(problem, "delta"), serve_cfg)
    rng = np.random.default_rng(23)
    for _ in range(3):
        server.submit_feedback(*_labeled_batch(problem, 4, rng))
        server.step()                      # chunk + auto-checkpoint
    engine_records = sorted(f for f in os.listdir(tmp_path)
                            if f.endswith(".npz"))
    assert engine_records == ["step_00000008.npz", "step_00000012.npz"]
    assert sorted(os.listdir(tmp_path / "store")) == engine_records


# ------------------------------------------------- one script, both servers
def _script(num_tasks, d, seed):
    """Submission script: labeled batches (some over the admission cap),
    label-free bursts on one task (the quota) and request batches."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(8):
        k = int(rng.integers(3, 9))
        t = rng.integers(0, num_tasks, size=k)
        if i % 3 == 1:
            out.append(("fb", (np.zeros(k, np.int64),)))
        else:
            x = (rng.standard_normal((k, d)) / np.sqrt(d)).astype(np.float32)
            y = rng.standard_normal(k).astype(np.float32)
            out.append(("fb", (t, x, y)))
        q = rng.integers(0, num_tasks, size=5)
        out.append(("predict", (q, rng.standard_normal((5, d))
                                .astype(np.float32))))
        out.append(("step", ()))
    return out


@pytest.mark.parametrize("engine", ("delta", "batch", "sharded"))
def test_same_script_as_the_jax_server(small_problem, problem, engine):
    """The sharded engine runs on both sides' 1-rank (1-device) mesh."""
    kw = dict(eta=1.0 / small_problem.lipschitz(), eta_k=0.7, tau=3,
              engine=engine)
    if engine in ("batch", "sharded"):
        kw.update(event_batch=2, prox_every=2)
    sc = dict(chunk_events=4, task_chunk_quota=2, max_pending_per_task=3)
    theirs = JServer(small_problem, JConfig(**kw),
                     jnp.zeros((problem.dim, problem.num_tasks)),
                     jax.random.PRNGKey(4), JServeConfig(**sc))
    mine = AMTLServer(problem, rt.AMTLConfig(**kw), _w0(problem),
                      prng.key_from_seed(4), ServeConfig(**sc),
                      device="cpu")
    for op, args in _script(problem.num_tasks, problem.dim, seed=7):
        if op == "fb":
            a, b = theirs.submit_feedback(*args), mine.submit_feedback(*args)
            assert (tuple(a), a.reason) == (tuple(b), b.reason)
        elif op == "step":
            assert theirs.step() == mine.step()
        else:
            a = np.asarray(theirs.predict(*args)).astype(np.float64)
            b = mine.predict(*args).numpy()
            q, x = args
            v = np.asarray(theirs.iterate())
            scale = np.linalg.norm(x, axis=1) * np.linalg.norm(v[:, q], axis=0)
            assert (np.abs(a - b) <= SERVE_RTOL * scale + 1e-30).all()
    assert mine.chunk_log == theirs.chunk_log and mine.chunk_log
    want, got = theirs.stats(), mine.stats()
    for key in ("requests", "predictions", "events", "chunks",
                "pending_feedback", "pending_rows", "store_rows",
                "rejected_feedback", "shed_feedback"):
        assert got[key] == want[key], key
    assert got["health"] == want["health"]
    v_jax = np.asarray(theirs.iterate())
    err = np.abs(mine.iterate().numpy() - v_jax).max()
    assert err <= SERVE_RTOL * np.abs(v_jax).max()
    for a, b in zip(mine._store.state(), theirs._store.state(), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
