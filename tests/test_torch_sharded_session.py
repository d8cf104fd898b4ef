"""The sharded cases of tests/test_engine_session.py on the port, at one
rank on the CPU: the session API, `run` composing bitwise at every split,
the checkpoint round trip (the reference's global-view record), the
decoupled prox cadence, the prox cache's placement, and `interop`'s
"sharded" kind against JAX's 1-device-mesh sharded state.  Records
crossing between the packages: tests/test_torch_checkpoint.py's
`sharded` engine; the sharded AMTLServer: tests/test_torch_serve.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import amtl as jamtl  # noqa: E402
from repro.launch.mesh import make_task_mesh as j_make_task_mesh  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.interop import (LEAVES, state_from_numpy,  # noqa: E402
                                 state_to_numpy)
from repro_torch.launch.mesh import make_task_mesh  # noqa: E402

OFFSETS = np.array([2.0, 0.0, 1.0, 0.0, 3.0], np.float32)


@pytest.fixture(scope="module")
def tp(small_problem):
    return rt.problem_from_numpy(np.asarray(small_problem.xs),
                                 np.asarray(small_problem.ys), "lstsq",
                                 "nuclear", 0.1, device="cpu")


@pytest.fixture(scope="module")
def mesh1():
    return make_task_mesh(1, device="cpu")


def _cfg(tp, engine="sharded", tau=3, **kw):
    kw.setdefault("event_batch", 4)
    kw.setdefault("prox_every", kw["event_batch"])
    return rt.AMTLConfig(eta=1.0 / tp.lipschitz(), eta_k=0.7, tau=tau,
                         engine=engine, **kw)


def _w0(tp):
    return np.zeros((tp.dim, tp.num_tasks), np.float32)


def _assert_states_equal(a, b, msg=""):
    for name, x, y in zip(LEAVES, state_to_numpy(a), state_to_numpy(b),
                          strict=True):
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} {name}")


def test_engine_metadata_and_iterate(tp, mesh1):
    eng = rt.make_engine(tp, _cfg(tp), mesh=mesh1)
    assert (eng.events_per_step, eng.num_tasks) == (4, tp.num_tasks)
    assert eng.mesh is mesh1 and eng.device == torch.device("cpu")
    state = eng.init(_w0(tp), prng.key_from_seed(0))
    assert eng.iterate(state).shape == (tp.dim, tp.num_tasks)
    with pytest.raises(ValueError, match=r"num_events \(10\).*event_batch"):
        eng.run(state, None, 10)


def test_run_matches_amtl_events_only(tp, mesh1):
    eng = rt.make_engine(tp, _cfg(tp), mesh=mesh1)
    key = prng.key_from_seed(7)
    got = eng.run(eng.init(_w0(tp), key), None, 20)
    want = rt.amtl_events_only(tp, _cfg(tp), _w0(tp), key, 20, mesh=mesh1)
    _assert_states_equal(got, want)


@pytest.mark.parametrize("split", [0, 1, 3, 5])
def test_session_splits_resume_bitwise(tp, mesh1, split):
    eng = rt.make_engine(tp, _cfg(tp), mesh=mesh1)
    key = prng.key_from_seed(4)
    total = 5 * eng.events_per_step
    full = eng.run(eng.init(_w0(tp), key), OFFSETS, total)
    mid = eng.run(eng.init(_w0(tp), key), OFFSETS, split * 4)
    before = state_to_numpy(mid)
    resumed = eng.run(mid, OFFSETS, total - split * 4)
    _assert_states_equal(full, resumed, f"split={split}")
    for a, b in zip(before, state_to_numpy(mid)):
        np.testing.assert_array_equal(a, b)       # run never mutates


@pytest.mark.parametrize("prox_mode", ["replicated", "distributed"])
def test_checkpoint_roundtrip_resumes_bitwise(tp, mesh1, prox_mode,
                                              tmp_path):
    """run(2N) == run(N) -> save -> restore -> run(N), full state, with
    and without the mesh given to save and restore."""
    cfg = _cfg(tp, dynamic_step=True, prox_rank=3, prox_mode=prox_mode,
               prox_every=8)
    eng = rt.make_engine(tp, cfg, mesh=mesh1)
    key = prng.key_from_seed(8)
    full = eng.run(eng.init(_w0(tp), key), OFFSETS, 24)
    half = eng.run(eng.init(_w0(tp), key), OFFSETS, 12)
    for sub, kw in (("plain", {}), ("mesh", dict(mesh=mesh1, cfg=cfg))):
        d = str(tmp_path / sub)
        checkpoint.save(d, half.event, half, **kw)
        assert checkpoint.latest_step(d) == 12
        restored = checkpoint.restore(d, 12, like=eng.init(_w0(tp), key),
                                      **kw)
        _assert_states_equal(half, restored, f"{sub} roundtrip")
        _assert_states_equal(full, eng.run(restored, OFFSETS, 12),
                             f"{sub} resume")


def test_sharded_decoupled_cadence_matches_batch(tp, mesh1):
    batch_cfg = _cfg(tp, "batch", event_batch=5, prox_every=15)
    b = rt.amtl_events_only(tp, batch_cfg, _w0(tp), prng.key_from_seed(6),
                            45, device="cpu")
    s = rt.amtl_events_only(tp, batch_cfg._replace(engine="sharded"),
                            _w0(tp), prng.key_from_seed(6), 45, mesh=mesh1)
    assert torch.equal(b.v, s.v) and torch.equal(b.p_cache, s.p_cache)
    assert torch.equal(b.delta_ring, s.delta_ring[0])


@pytest.mark.parametrize("prox_mode", ["replicated", "distributed"])
def test_prox_cache_carried_only_when_decoupled(tp, mesh1, prox_mode):
    kw = dict(prox_mode=prox_mode, prox_rank=3)
    aligned = rt.make_engine(tp, _cfg(tp, **kw), mesh=mesh1)
    st = aligned.init(_w0(tp), prng.key_from_seed(0))
    assert isinstance(st, rt.core.ShardedAMTLState)
    assert st.p_cache.shape == (0, 0)
    decoupled = rt.make_engine(tp, _cfg(tp, prox_every=8, **kw), mesh=mesh1)
    assert decoupled.init(_w0(tp), prng.key_from_seed(0)).p_cache.shape \
        == (tp.dim, tp.num_tasks)


def test_interop_sharded_leaves_roundtrip_with_jax(small_problem, tp,
                                                   mesh1):
    """JAX's 1-device-mesh sharded state crosses into the port and resumes
    there; its leaves are the reference's layout (delta_ring (1, tau+1,
    d)) and the port's state crosses back bitwise."""
    kw = dict(eta=1.0 / small_problem.lipschitz(), eta_k=0.7, tau=3,
              engine="sharded", event_batch=4, prox_every=8, prox_rank=3)
    je = jamtl.make_engine(small_problem, jamtl.AMTLConfig(**kw),
                           j_make_task_mesh(1))
    js = je.run(je.init(jnp.asarray(_w0(tp)), jax.random.PRNGKey(3)), None,
                12)
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]
    mine = state_from_numpy("sharded", leaves, device="cpu")
    assert isinstance(mine, rt.core.ShardedAMTLState)
    for name, a, b in zip(LEAVES, leaves, state_to_numpy(mine)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    eng = rt.make_engine(tp, rt.AMTLConfig(**kw), mesh=mesh1)
    ours = eng.run(mine, None, 12)
    theirs = je.run(js, None, 12)
    np.testing.assert_array_equal(ours.task_ring, np.asarray(theirs.task_ring))
    np.testing.assert_array_equal(ours.key, np.asarray(theirs.key))
    want = np.asarray(theirs.v, np.float64)
    assert np.abs(ours.v.numpy() - want).max() <= 1e-4 * np.abs(want).max()
