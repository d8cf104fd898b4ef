"""The port's dense engine (`engine="dense"`) and the l2,1 formulation
(`reg_name="l21"`) on the CPU, against the reference's JAX engines and
against the port's own delta engine.

Against JAX, same problem (numpy-seeded, d 24, T 6), same PRNGKey, tau 3,
60 events with delay offsets: `ptr`, `event`, `history` and `key`
bitwise (the dense state has no task ring; the delta and batch states'
`task_ring` is bitwise too); the ring, `v`, `delta_ring` and `p_cache`
within ENGINE_RTOL of their scale — the per-event gradients are float32
matrix products that PyTorch and XLA sum in another order, and the prox
rounds apart (SVD; the l2,1 row norms), so the iterates drift by float32
rounding over the run.

Within the port (CPU, plain versions): dense equals delta bitwise at
prox_every=1, as the reference's tests/test_amtl_delta.py holds it; `run`
composes bitwise and never mutates its input.  On the card chip_smoke.py
holds the same dense == delta gate over 256 events at full width.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import amtl as jamtl  # noqa: E402
from repro.core.losses import MTLProblem as JProblem  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import amtl  # noqa: E402
from repro_torch.interop import (DENSE_LEAVES, LEAVES,  # noqa: E402
                                 state_from_numpy, state_to_numpy)
from repro_torch.kernels import ops  # noqa: E402

ENGINE_RTOL = 1e-4
D, T, TAU, EVENTS = 24, 6, 3, 60
OFFSETS = np.array([3.0, 1.0, 0.0, 2.0, 4.0, 1.0], np.float32)
HOST = {"ptr", "event", "history.buf", "history.count", "key", "task_ring"}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, 30, D)).astype(np.float32)
    w_star = (rng.standard_normal((D, 2))
              @ rng.standard_normal((2, T))).astype(np.float32)
    # a few zero rows of W*, so the l2,1 threshold has rows to remove
    w_star[::5] = 0.0
    ys = (np.einsum("tnd,dt->tn", xs, w_star)
          + 0.1 * rng.standard_normal((T, 30))).astype(np.float32)
    return xs, ys


@pytest.fixture(scope="module", params=["l21", "nuclear"])
def problems(request):
    xs, ys = _data()
    lam = 0.5
    jp = JProblem(jnp.asarray(xs), jnp.asarray(ys), "lstsq", request.param,
                  lam)
    tp = rt.problem_from_numpy(xs, ys, "lstsq", request.param, lam,
                               device="cpu")
    return jp, tp


def _cfgs(jp, **kw):
    kw = {"eta": 1.0 / jp.lipschitz(), "eta_k": 0.7, "tau": TAU, **kw}
    return jamtl.AMTLConfig(**kw), rt.AMTLConfig(**kw)


def _assert_match(jax_state, port_state):
    names = DENSE_LEAVES if isinstance(port_state, amtl.AMTLState) \
        else LEAVES
    want = dict(zip(names, (np.asarray(a) for a in
                            jax.tree_util.tree_leaves(jax_state))))
    got = dict(zip(names, state_to_numpy(port_state)))
    for f in names:
        assert got[f].shape == want[f].shape \
            and got[f].dtype == want[f].dtype, f
        if f in HOST:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            scale = max(np.abs(want[f]).max(initial=0.0), 1e-30)
            err = np.abs(got[f] - want[f].astype(np.float64)).max(initial=0.0)
            assert err <= ENGINE_RTOL * scale, (f, err, scale)


def _v0():
    return np.full((D, T), 0.01, np.float32)


@pytest.mark.parametrize("dynamic_step", [False, True])
def test_dense_matches_jax(problems, dynamic_step):
    jp, tp = problems
    jcfg, tcfg = _cfgs(jp, engine="dense", dynamic_step=dynamic_step)
    key = jax.random.PRNGKey(11)
    je = jamtl.make_engine(jp, jcfg)
    te = rt.make_engine(tp, tcfg, device="cpu")
    js = je.run(je.init(jnp.asarray(_v0()), key), jnp.asarray(OFFSETS),
                EVENTS)
    ts = te.run(te.init(_v0(), np.asarray(key)), OFFSETS, EVENTS)
    _assert_match(js, ts)
    _assert_match(je.run(js, jnp.asarray(OFFSETS), EVENTS),
                  te.run(ts, OFFSETS, EVENTS))
    np.testing.assert_allclose(
        rt.current_iterate(ts).numpy(), np.asarray(jamtl.current_iterate(js)),
        rtol=0, atol=ENGINE_RTOL * np.abs(np.asarray(js.ring)).max())


@pytest.mark.parametrize("tau,dynamic_step", [(3, False), (3, True),
                                              (0, False), (6, True)])
def test_dense_equals_delta_bitwise(problems, tau, dynamic_step):
    _, tp = problems
    key = rt.core.prng.key_from_seed(7)
    cfg = rt.AMTLConfig(eta=0.01, eta_k=0.7, tau=tau, engine="dense",
                        dynamic_step=dynamic_step)
    dense = rt.amtl_events_only(tp, cfg, _v0(), key, EVENTS, OFFSETS,
                                device="cpu")
    delta = rt.amtl_events_only(tp, cfg._replace(engine="delta"), _v0(), key,
                                EVENTS, OFFSETS, device="cpu")
    assert torch.equal(rt.current_iterate(dense), delta.v)
    for f in ("ptr", "event"):
        assert getattr(dense, f) == getattr(delta, f), f
    np.testing.assert_array_equal(dense.key, delta.key)
    np.testing.assert_array_equal(dense.history.buf, delta.history.buf)
    # every older ring slot is the delta engine's rollback of that age
    for nu in range(tau + 1):
        old = rt.core.rollback_columns(delta.v, delta.delta_ring,
                                       delta.task_ring, delta.ptr, nu, tau)
        assert torch.equal(dense.ring[(dense.ptr - nu) % (tau + 1)], old)


def test_dense_amtl_solve_equals_delta(problems):
    _, tp = problems
    cfg = rt.AMTLConfig(eta=0.01, eta_k=0.7, tau=TAU, engine="dense")
    key = rt.core.prng.key_from_seed(8)
    a = rt.amtl_solve(tp, cfg, _v0(), key, num_epochs=3, device="cpu")
    b = rt.amtl_solve(tp, cfg._replace(engine="delta"), _v0(), key,
                      num_epochs=3, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_dense_run_composes_and_leaves_input_untouched(problems):
    _, tp = problems
    cfg = rt.AMTLConfig(eta=0.01, eta_k=0.7, tau=TAU, engine="dense",
                        dynamic_step=True)
    eng = rt.make_engine(tp, cfg, device="cpu")
    s0 = eng.init(_v0(), rt.core.prng.key_from_seed(4))
    s8 = eng.run(s0, OFFSETS, 8)
    before = state_to_numpy(s8)
    whole = eng.run(s0, OFFSETS, 24)
    split = eng.run(s8, OFFSETS, 16)
    for a, c, name in zip(state_to_numpy(whole), state_to_numpy(split),
                          DENSE_LEAVES):
        np.testing.assert_array_equal(a, c, err_msg=name)
    for a, c, name in zip(before, state_to_numpy(s8), DENSE_LEAVES):
        np.testing.assert_array_equal(a, c, err_msg=f"mutated {name}")
    assert eng.events_per_step == 1


def test_jax_dense_state_crosses_both_ways(problems):
    """A reference AMTLState continues in the port, and the port's state
    continues in the reference, on the same event stream."""
    jp, tp = problems
    jcfg, tcfg = _cfgs(jp, engine="dense")
    je = jamtl.make_engine(jp, jcfg)
    te = rt.make_engine(tp, tcfg, device="cpu")
    offs = jnp.asarray(OFFSETS)
    mid = je.run(je.init(jnp.asarray(_v0()), jax.random.PRNGKey(21)), offs,
                 30)
    leaves, treedef = jax.tree_util.tree_flatten(mid)
    port_mid = state_from_numpy("dense", [np.asarray(x) for x in leaves],
                                device="cpu")
    _assert_match(mid, port_mid)
    _assert_match(je.run(mid, offs, 30), te.run(port_mid, OFFSETS, 30))
    back = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for x in state_to_numpy(port_mid)])
    _assert_match(je.run(back, offs, 30), te.run(port_mid, OFFSETS, 30))


def test_dense_refuses_ragged_and_minibatch(problems):
    _, tp = problems
    cfg = rt.AMTLConfig(eta=0.01, eta_k=0.7, tau=TAU, engine="dense")
    ragged = tp._replace(row_counts=torch.full((T,), 20, dtype=torch.int32))
    with pytest.raises(ValueError, match="dense"):
        rt.make_engine(ragged, cfg, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        rt.make_engine(tp, cfg._replace(batch_size=8), device="cpu")
    with pytest.raises(ValueError, match="dense"):
        rt.make_engine(tp, cfg._replace(prox_every=2), device="cpu")


@pytest.mark.parametrize("case", [
    dict(engine="batch", event_batch=4, prox_every=8),
    dict(engine="batch", event_batch=4, prox_every=4, dynamic_step=True),
    dict(engine="delta", prox_every=3),
], ids=["batch_k2", "batch_k1_dynamic", "delta_k3"])
def test_l21_engines_match_jax(case):
    """The l2,1 formulation on the delta and batch engines against JAX;
    every refresh is `ops.l21_prox`, which on the CPU launches nothing."""
    xs, ys = _data(1)
    jp = JProblem(jnp.asarray(xs), jnp.asarray(ys), "lstsq", "l21", 0.5)
    tp = rt.problem_from_numpy(xs, ys, "lstsq", "l21", 0.5, device="cpu")
    jcfg, tcfg = _cfgs(jp, **case)
    key = jax.random.PRNGKey(3)
    je = jamtl.make_engine(jp, jcfg)
    te = rt.make_engine(tp, tcfg, device="cpu")
    js = je.run(je.init(jnp.asarray(_v0()), key), jnp.asarray(OFFSETS), 64)
    ops.reset_launch_counts()
    ts = te.run(te.init(_v0(), np.asarray(key)), OFFSETS, 64)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    _assert_match(js, ts)
