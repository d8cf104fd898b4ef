"""The port's engine session (`repro_torch.core.amtl`) on the CPU against the
reference's JAX engines, and the reference's engine contracts inside the
port.

Against JAX, same problem, same PRNGKey: `task_ring`, `ptr`, `event`,
`history` and `key` bitwise; `v`, `delta_ring` and `p_cache` to
ENGINE_RTOL of their scale — the per-event gradients are float32 matrix
products that PyTorch and XLA sum in another order, and the prox's SVD/QR
round apart, so the iterates drift by float32 rounding over the run.

Within the port (CPU, plain versions): batch equals delta bitwise at a
matched prox cadence, `run` composes bitwise and never mutates its input.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import amtl as jamtl  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import amtl  # noqa: E402
from repro_torch.interop import LEAVES, state_to_numpy  # noqa: E402

ENGINE_RTOL = 1e-4
HOST_FIELDS = ("task_ring", "ptr", "event", "history.buf", "history.count",
               "key")


@pytest.fixture(scope="module")
def problems(small_problem):
    xs, ys = np.asarray(small_problem.xs), np.asarray(small_problem.ys)
    return small_problem, rt.problem_from_numpy(xs, ys, "lstsq", "nuclear",
                                                0.1, device="cpu")


def _cfgs(jp, **kw):
    kw = {"eta": 1.0 / jp.lipschitz(), "eta_k": 0.7, "tau": 3, **kw}
    return jamtl.AMTLConfig(**kw), rt.AMTLConfig(**kw)


def _assert_states_match(jax_state, port_state):
    leaves = dict(zip(LEAVES, (np.asarray(a) for a in
                               jax.tree_util.tree_leaves(jax_state))))
    mine = dict(zip(LEAVES, state_to_numpy(port_state)))
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(mine[f], leaves[f], err_msg=f)
    for f in ("v", "delta_ring", "p_cache"):
        want = leaves[f].astype(np.float64)
        scale = max(np.abs(want).max(initial=0.0), 1e-30)
        err = np.abs(mine[f] - want).max(initial=0.0)
        assert err <= ENGINE_RTOL * scale, (f, err, scale)


ENGINE_CASES = [
    dict(engine="delta"),
    dict(engine="delta", prox_every=4, prox_rank=3, dynamic_step=True),
    dict(engine="delta", tau=0),
    dict(engine="batch", event_batch=5, prox_every=5),
    dict(engine="batch", event_batch=5, prox_every=10, prox_rank=3,
         dynamic_step=True, tau=4),
    dict(engine="batch", event_batch=2, prox_every=6, delay_jitter=2.5),
]


@pytest.mark.parametrize("case", ENGINE_CASES,
                         ids=[str(i) for i in range(len(ENGINE_CASES))])
def test_engine_matches_jax(problems, case):
    jp, tp = problems
    jcfg, tcfg = _cfgs(jp, **case)
    offsets = np.array([3.0, 1.0, 0.0, 2.0, 4.0], np.float32)
    key = jax.random.PRNGKey(11)
    v0 = np.full((jp.dim, jp.num_tasks), 0.01, np.float32)
    je = jamtl.make_engine(jp, jcfg)
    te = rt.make_engine(tp, tcfg, device="cpu")
    n = 60
    js = je.run(je.init(jnp.asarray(v0), key), jnp.asarray(offsets), n)
    ts = te.run(te.init(v0, np.asarray(key)), offsets, n)
    _assert_states_match(js, ts)
    # and a second leg from the reached state
    _assert_states_match(je.run(js, jnp.asarray(offsets), n),
                         te.run(ts, offsets, n))


@pytest.mark.parametrize("tau,bsz,k,extra", [
    (3, 5, 1, {}),                         # bsz > tau + 1: ring tail only
    (8, 5, 1, {}),
    (4, 5, 2, dict(dynamic_step=True, prox_rank=3)),
    (3, 2, 3, dict(delay_jitter=2.0)),
])
def test_batch_equals_delta_bitwise(problems, tau, bsz, k, extra):
    """Matched cadence, aligned (k=1) and decoupled (prox_every = k*B)."""
    jp, tp = problems
    _, delta = _cfgs(jp, tau=tau, engine="delta", prox_every=k * bsz,
                     **extra)
    batch = delta._replace(engine="batch", event_batch=bsz)
    offsets = np.array([3.0, 1.0, 0.0, 2.0, 4.0], np.float32)
    v0 = np.zeros((tp.dim, tp.num_tasks), np.float32)
    key = rt.core.prng.key_from_seed(3)
    n = 4 * k * bsz
    d = rt.amtl_events_only(tp, delta, v0, key, n, offsets, device="cpu")
    b = rt.amtl_events_only(tp, batch, v0, key, n, offsets, device="cpu")
    for a, c, name in zip(state_to_numpy(d), state_to_numpy(b), LEAVES):
        if name == "p_cache" and k == 1:
            # delta carries a cache at prox_every > 1; aligned batch does not
            continue
        np.testing.assert_array_equal(a, c, err_msg=name)


@pytest.mark.parametrize("case", [
    dict(engine="delta", prox_every=3, prox_rank=2),
    dict(engine="batch", event_batch=4, prox_every=8, dynamic_step=True),
])
def test_run_composes_and_leaves_input_untouched(problems, case):
    jp, tp = problems
    _, cfg = _cfgs(jp, **case)
    eng = rt.make_engine(tp, cfg, device="cpu")
    s0 = eng.init(np.zeros((tp.dim, tp.num_tasks), np.float32),
                  rt.core.prng.key_from_seed(4))
    s8 = eng.run(s0, None, 8)
    before = state_to_numpy(s8)
    whole = eng.run(s0, None, 24)
    split = eng.run(s8, None, 16)
    for a, c, name in zip(state_to_numpy(whole), state_to_numpy(split),
                          LEAVES):
        np.testing.assert_array_equal(a, c, err_msg=name)
    for a, c, name in zip(before, state_to_numpy(s8), LEAVES):
        np.testing.assert_array_equal(a, c, err_msg=f"mutated {name}")


def test_amtl_solve_and_default_config_match(problems):
    jp, tp = problems
    jcfg = jamtl.default_config(jp, tau=3, engine="batch", event_batch=5,
                                prox_every=5)
    tcfg = amtl.default_config(tp, tau=3, engine="batch", event_batch=5,
                               prox_every=5)
    assert tuple(jcfg) == tuple(tcfg)
    v0 = np.zeros((jp.dim, jp.num_tasks), np.float32)
    key = jax.random.PRNGKey(9)
    jr = jamtl.amtl_solve(jp, jcfg, jnp.asarray(v0), key, num_epochs=3)
    tr = rt.amtl_solve(tp, tcfg, v0, np.asarray(key), num_epochs=3,
                       device="cpu")
    np.testing.assert_allclose(tr.objectives.numpy(),
                               np.asarray(jr.objectives), rtol=ENGINE_RTOL)
    np.testing.assert_allclose(tr.residuals.numpy(),
                               np.asarray(jr.residuals), rtol=1e-3)
    scale = np.abs(np.asarray(jr.w)).max()
    assert np.abs(tr.w.numpy() - np.asarray(jr.w)).max() \
        <= ENGINE_RTOL * scale
    assert rt.current_iterate(rt.make_engine(tp, tcfg, device="cpu").init(
        v0, np.asarray(key))).shape == (jp.dim, jp.num_tasks)


BAD_CONFIGS = [
    dict(engine="nope"),
    dict(prox_every=0),
    dict(event_batch=0, engine="batch"),
    dict(engine="delta", event_batch=4),
    dict(engine="dense", prox_every=2),
    dict(engine="dense", prox_rank=3),
    dict(batch_size=0),
    dict(engine="dense", batch_size=4),
    dict(engine="batch", event_batch=4, prox_every=6),
    dict(prox_mode="sideways"),
    dict(prox_mode="distributed", engine="batch", event_batch=2,
         prox_every=2, prox_rank=2),
    dict(prox_mode="distributed", engine="sharded", event_batch=2,
         prox_every=2),
]


@pytest.mark.parametrize("bad", BAD_CONFIGS,
                         ids=[str(i) for i in range(len(BAD_CONFIGS))])
def test_validate_config_raises_where_jax_does(bad):
    kw = dict(eta=0.1, eta_k=0.5, tau=2, **bad)
    with pytest.raises(ValueError):
        jamtl.validate_config(jamtl.AMTLConfig(**kw))
    with pytest.raises(ValueError):
        amtl.validate_config(rt.AMTLConfig(**kw))


def test_validate_config_prox_rank_needs_nuclear():
    kw = dict(eta=0.1, eta_k=0.5, tau=2, prox_rank=3)
    for reg in ("l21", "ridge"):
        with pytest.raises(ValueError):
            jamtl.validate_config(jamtl.AMTLConfig(**kw), reg)
        with pytest.raises(ValueError):
            amtl.validate_config(rt.AMTLConfig(**kw), reg)
    jamtl.validate_config(jamtl.AMTLConfig(**kw), "nuclear")
    amtl.validate_config(rt.AMTLConfig(**kw), "nuclear")


@pytest.mark.parametrize("case", [
    dict(engine="dense"),
    dict(engine="sharded", event_batch=2, prox_every=2),
    dict(engine="delta", batch_size=8),
])
def test_ported_engines_run_and_sharded_refused(problems, case):
    """Every engine is ported and runs: the dense engine, SGD
    (`batch_size`) and the sharded engine, which no longer refuses (on
    the default 1-rank mesh outside a torch.distributed world)."""
    _, tp = problems
    cfg = rt.AMTLConfig(eta=0.1, eta_k=0.5, tau=2, **case)
    eng = rt.make_engine(tp, cfg, device="cpu")
    s = eng.run(eng.init(np.zeros((tp.dim, tp.num_tasks), np.float32),
                         rt.core.prng.key_from_seed(0)), None, 4)
    assert s.event == 4 and bool(torch.isfinite(eng.iterate(s)).all())
    if case["engine"] == "sharded":
        assert eng.mesh.size == 1 and s.delta_ring.shape == (1, 3, tp.dim)


def test_ragged_problem_refused_and_bad_event_count(problems):
    """A ragged problem (`row_counts`) is ported and runs on the batch
    engine (only the dense engine refuses it); a run whose event count is
    not a multiple of event_batch is refused."""
    _, tp = problems
    cfg = rt.AMTLConfig(eta=0.1, eta_k=0.5, tau=2, engine="batch",
                        event_batch=4, prox_every=4)
    ragged = tp._replace(row_counts=torch.full((tp.num_tasks,), 10,
                                               dtype=torch.int32))
    with pytest.raises(ValueError, match="dense"):
        rt.make_engine(ragged, cfg._replace(engine="dense", event_batch=1,
                                            prox_every=1), device="cpu")
    s = rt.amtl_events_only(ragged, cfg,
                            np.zeros((tp.dim, tp.num_tasks), np.float32),
                            rt.core.prng.key_from_seed(0), 8, device="cpu")
    assert s.event == 8 and bool(torch.isfinite(s.v).all())
    eng = rt.make_engine(tp, cfg, device="cpu")
    s = eng.init(np.zeros((tp.dim, tp.num_tasks), np.float32),
                 rt.core.prng.key_from_seed(0))
    with pytest.raises(ValueError):
        eng.run(s, None, 6)
    assert eng.events_per_step == 4 and eng.num_tasks == tp.num_tasks
