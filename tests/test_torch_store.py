"""The port's TaskStore (`repro_torch.data.store`) and data generators:
the reference's store contracts (tests/test_taskstore.py), the checkpoint
round trip, the same append script against the JAX TaskStore (buffers
and counts bitwise), and ragged problems through the port's engines.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.data import TaskStore as JStore  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import TaskStore, synthetic  # noqa: E402
from repro_torch.interop import LEAVES, state_to_numpy  # noqa: E402


def _ragged_lists(sizes, d, seed=0):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
          for n in sizes]
    ys = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    return xs, ys


def _store(sizes, d, seed):
    return TaskStore.from_ragged(*_ragged_lists(sizes, d, seed),
                                 loss_name="lstsq", reg_name="nuclear",
                                 lam=0.1)


def _assert_state_equal(a, b):
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_from_ragged_pads_and_masks():
    xs, ys = _ragged_lists([3, 7, 2], d=5, seed=2)
    store = TaskStore.from_ragged(xs, ys, "lstsq", "nuclear", 0.1)
    assert (store.num_tasks, store.capacity, store.dim) == (3, 7, 5)
    assert store.row_counts.tolist() == [3, 7, 2]
    assert store.num_rows == 12
    prob = store.problem("cpu")
    assert prob.xs.shape == (3, 7, 5)
    assert prob.row_counts.dtype == torch.int32
    assert prob.row_counts.tolist() == [3, 7, 2]
    np.testing.assert_array_equal(prob.xs[0, :3].numpy(), xs[0])
    assert not prob.xs[0, 3:].any()
    np.testing.assert_array_equal(prob.ys[2, :2].numpy(), ys[2])


def test_append_arrival_order_and_pow2_growth():
    store = _store([2, 3], d=4, seed=3)
    assert store.capacity == 3
    rng = np.random.default_rng(4)
    x6 = rng.standard_normal((6, 4)).astype(np.float32)
    y6 = rng.standard_normal(6).astype(np.float32)
    assert store.append([0, 1, 0, 0, 1, 0], x6, y6) == 6
    assert store.capacity == 6
    assert store.row_counts.tolist() == [6, 5]
    prob = store.problem("cpu")
    np.testing.assert_array_equal(prob.xs[0, 2:].numpy(), x6[[0, 2, 3, 5]])
    np.testing.assert_array_equal(prob.ys[1, 3:5].numpy(), y6[[1, 4]])
    store.append([1, 1], x6[:2], y6[:2])
    assert store.capacity == 12
    assert store.row_counts.tolist() == [6, 7]


def test_append_validates():
    store = _store([2, 2], d=3, seed=5)
    with pytest.raises(ValueError, match="append expects features"):
        store.append([0], np.zeros((1, 5), np.float32), [0.0])
    with pytest.raises(ValueError, match="append expects features"):
        store.append([0, 1], np.zeros((2, 3), np.float32), [0.0])
    with pytest.raises(ValueError, match="task_ids must lie"):
        store.append([2], np.zeros((1, 3), np.float32), [0.0])
    assert store.append([], np.zeros((0, 3), np.float32), []) == 0


def test_problem_view_cached_until_append():
    store = _store([2, 4], d=3, seed=6)
    p1 = store.problem("cpu")
    assert store.problem("cpu") is p1
    store.append([0], np.ones((1, 3), np.float32), [1.0])
    p2 = store.problem("cpu")
    assert p2 is not p1
    assert p2.row_counts.tolist() == [3, 4]
    # a problem handed out earlier keeps its contents
    assert p1.row_counts.tolist() == [2, 4]
    assert not p1.xs[0, 2].any()


def test_undo_rollback_bitwise_across_a_doubling():
    store = _store([3, 5, 1], d=4, seed=7)
    before = store.state()
    cap0 = store.capacity
    p0 = store.problem("cpu")
    rng = np.random.default_rng(8)
    ids = [1, 1, 0, 1, 2]                      # task 1: 5 -> 8 > cap 5
    undo = store.append_undoable(ids, rng.standard_normal((5, 4)),
                                 rng.standard_normal(5))
    assert store.capacity == 10
    assert store.problem("cpu") is not p0
    store.rollback(undo)
    assert store.capacity == cap0
    _assert_state_equal(store.state(), before)
    # an undo inside the capacity restores the overwritten slots' bytes
    small = store.append_undoable([0, 2], np.ones((2, 4)), [2.0, 3.0])
    store.rollback(small)
    _assert_state_equal(store.state(), before)


def test_checkpoint_waits_for_its_slice(tmp_path):
    """The checkpoint round trip (the reference's
    test_checkpoint_roundtrip_bitwise): buffers, counts and the grown
    capacity come back bitwise."""
    store = _store([2, 2], d=3, seed=9)
    store.append([0, 0, 0], np.ones((3, 3), np.float32), [1.0, 2.0, 3.0])
    assert store.capacity == 8
    store.save(str(tmp_path), 1)
    back = TaskStore.restore(str(tmp_path), 1, "lstsq", "nuclear", 0.1)
    assert back.capacity == 8
    _assert_state_equal(back.state(), store.state())
    np.testing.assert_array_equal(back.problem("cpu").xs.numpy(),
                                  store.problem("cpu").xs.numpy())


def test_same_append_script_as_the_jax_store_bitwise():
    xs, ys = _ragged_lists([4, 9, 1, 6], d=5, seed=10)
    mine = TaskStore.from_ragged(xs, ys, "lstsq", "nuclear", 0.1)
    theirs = JStore.from_ragged(xs, ys, "lstsq", "nuclear", 0.1)
    rng = np.random.default_rng(11)
    for k in (3, 0, 7, 12, 1):
        ids = rng.integers(0, 4, size=k)
        f = rng.standard_normal((k, 5)).astype(np.float32)
        y = rng.standard_normal(k).astype(np.float32)
        assert mine.append(ids, f, y) == theirs.append(ids, f, y)
        assert mine.capacity == theirs.capacity
        _assert_state_equal(mine.state(), theirs.state())
    u1 = mine.append_undoable([0, 0, 0], np.ones((3, 5)), np.ones(3))
    u2 = theirs.append_undoable([0, 0, 0], np.ones((3, 5)), np.ones(3))
    mine.rollback(u1)
    theirs.rollback(u2)
    _assert_state_equal(mine.state(), theirs.state())
    jp = theirs.problem()
    tp = mine.problem("cpu")
    np.testing.assert_array_equal(tp.xs.numpy(), np.asarray(jp.xs))
    np.testing.assert_array_equal(tp.row_counts.numpy(),
                                  np.asarray(jp.row_counts))
    # a store's state crosses in both directions as its numpy leaves
    back = TaskStore(*theirs.state(), "lstsq", "nuclear", 0.1)
    _assert_state_equal(back.state(), theirs.state())
    again = JStore(*mine.state(), "lstsq", "nuclear", 0.1)
    _assert_state_equal(again.state(), mine.state())


def test_from_problem_and_interop_row_counts(small_problem):
    xs, ys = np.asarray(small_problem.xs), np.asarray(small_problem.ys)
    p = rt.problem_from_numpy(xs, ys, "lstsq", "nuclear", 0.1, device="cpu")
    store = TaskStore.from_problem(p)
    assert store.capacity == xs.shape[1]
    assert (store.row_counts == xs.shape[1]).all()
    counts = [3, 50, 0, 7, 20]
    pr = rt.problem_from_numpy(xs, ys, "lstsq", "nuclear", 0.1,
                               device="cpu", row_counts=counts)
    assert pr.row_counts.dtype == torch.int32
    assert TaskStore.from_problem(pr).row_counts.tolist() == counts


def test_synthetic_data_are_the_reference_bytes():
    jp = jsyn.make_mtl_problem(num_tasks=3, samples=7, dim=5, seed=4)
    tp = synthetic.make_mtl_problem(num_tasks=3, samples=7, dim=5, seed=4,
                                    device="cpu")
    np.testing.assert_array_equal(tp.xs.numpy(), np.asarray(jp.xs))
    np.testing.assert_array_equal(tp.ys.numpy(), np.asarray(jp.ys))
    for mine, theirs in ((synthetic.make_school_like(1),
                          jsyn.make_school_like(1)),
                         (synthetic.make_mnist_like(samples=50, seed=2),
                          jsyn.make_mnist_like(samples=50, seed=2))):
        assert mine.losses == theirs.losses
        for a, b in zip(mine.xs + mine.ys, theirs.xs + theirs.ys,
                        strict=True):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------ ragged problems, engines

def _cfg(problem, engine, **kw):
    if engine == "batch":
        kw.setdefault("event_batch", 4)
        kw.setdefault("prox_every", kw["event_batch"])
    return rt.AMTLConfig(eta=1.0 / problem.lipschitz(), eta_k=0.7, tau=3,
                         engine=engine, **kw)


def _run(problem, cfg, n, key=0, state=None):
    eng = rt.make_engine(problem, cfg, device="cpu")
    if state is None:
        state = eng.init(np.zeros((problem.dim, problem.num_tasks),
                                  np.float32), prng.key_from_seed(key))
    return eng.run(state, None, n)


@pytest.mark.parametrize("engine", ["delta", "batch"])
@pytest.mark.parametrize("batch_size", [None, 4])
def test_uniform_row_counts_are_bitwise_baseline(small_problem, engine,
                                                 batch_size):
    xs, ys = np.asarray(small_problem.xs), np.asarray(small_problem.ys)
    p = rt.problem_from_numpy(xs, ys, "lstsq", "nuclear", 0.1, device="cpu")
    uniform = TaskStore.from_problem(p).problem("cpu")
    cfg = _cfg(p, engine, batch_size=batch_size)
    for a, b, name in zip(state_to_numpy(_run(p, cfg, 24)),
                          state_to_numpy(_run(uniform, cfg, 24)), LEAVES):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_dense_engine_rejects_ragged():
    p = rt.stack_ragged(*_ragged_lists([6, 17, 11, 3], 8, seed=1), "lstsq",
                        "nuclear", 0.1, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        rt.make_engine(p, rt.AMTLConfig(eta=0.1, eta_k=0.5, tau=2,
                                        engine="dense"), device="cpu")


@pytest.mark.parametrize("batch_size", [None, 3])
def test_mid_session_append_continues_event_stream(batch_size):
    """Rebuilding the engine on a grown store continues the same stream,
    and the next run's minibatches are drawn over the new counts."""
    store = _store([6, 17, 11, 3], d=8, seed=1)
    p1 = store.problem("cpu")
    cfg = _cfg(p1, "delta", batch_size=batch_size)
    st = _run(p1, cfg, 8, key=13)
    rng = np.random.default_rng(14)
    store.append([0, 3, 3], rng.standard_normal((3, 8)),
                 rng.standard_normal(3))
    p2 = store.problem("cpu")
    st2 = _run(p2, cfg, 8, state=st)
    ref_st = _run(p1, cfg, 8, state=st)
    np.testing.assert_array_equal(st2.key, ref_st.key)
    np.testing.assert_array_equal(st2.history.buf, ref_st.history.buf)
    assert st2.event == 16
    if batch_size is not None:
        from repro_torch.core import amtl
        plan = amtl.plan_events(p2, cfg, st, np.zeros(4, np.float32), 8)
        np.testing.assert_array_equal(plan.scalars[:, 3],
                                      store.row_counts[plan.tasks])
