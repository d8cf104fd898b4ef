"""The port's AMTL head (`repro_torch.core.mtl_head`) against the
reference's `repro.core.mtl_head`, on the CPU, with the reference's
properties.

Both get the same numpy pooled states, task ids, targets and keys.  The
draws (staleness, activation mask) and the host counters are bitwise; the
iterates (the ring, p, the probe gradients) to 1e-5 of their scale
(float32 sums and the SVD in another library; seen at most 1e-6).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MTLCfg as JCfg  # noqa: E402
from repro.core import mtl_head as J  # noqa: E402
from repro_torch.configs.base import MTLCfg  # noqa: E402
from repro_torch.core import mtl_head as P  # noqa: E402

D, T = 16, 4
KW = dict(num_tasks=T, reg_name="nuclear", lam=0.01, tau=3,
          activation_rate=1.0, dynamic_step=False, eta=0.05, km_relax=0.8)
RTOL = 1e-5


def cfgs(**changes):
    kw = {**KW, **changes}
    return JCfg(**kw), MTLCfg(**kw)


def data(seed=0, n=256, t=T, noise=0.02):
    rng = np.random.default_rng(seed)
    w_true = (rng.standard_normal((D, t)) / np.sqrt(D)).astype(np.float32)
    pooled = rng.standard_normal((n, D)).astype(np.float32)
    tids = rng.integers(0, t, n).astype(np.int32)
    y = (np.einsum("nd,nd->n", pooled, w_true.T[tids])
         + noise * rng.standard_normal(n)).astype(np.float32)
    return w_true, pooled, tids, y


def tt(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def port_state(js):
    return P.MTLHeadState(torch.from_numpy(np.array(js.ring)), int(js.ptr),
                          int(js.step), np.array(js.delay_buf),
                          np.array(js.delay_cnt))


def pushed_states(jc, pc, k=6):
    """Both packages' states after k distinguishable iterates."""
    js = J.init_mtl_state(D, jc)
    for i in range(k):
        ring = js.ring.at[(js.ptr + 1) % (jc.tau + 1)].set(
            jnp.full((D, T), float(i + 1)) + jnp.arange(T, dtype=jnp.float32))
        js = js._replace(ring=ring, ptr=(js.ptr + 1) % (jc.tau + 1),
                         step=js.step + 1)
    return js, port_state(js)


def test_init_matches():
    jc, pc = cfgs()
    js, ps = J.init_mtl_state(D, jc), P.init_mtl_state(D, pc)
    assert ps.ring.shape == js.ring.shape and ps.ring.dtype == torch.float32
    assert not ps.ring.any() and ps.ptr == 0 and ps.step == 0
    np.testing.assert_array_equal(ps.delay_buf, np.asarray(js.delay_buf))
    np.testing.assert_array_equal(ps.delay_cnt, np.asarray(js.delay_cnt))
    assert ps.delay_cnt.dtype == np.int32


@pytest.mark.parametrize("seed", range(4))
def test_stale_read_matches(seed):
    jc, pc = cfgs()
    js, ps = pushed_states(jc, pc, k=2 + seed)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    jv, jnu = J.stale_read(js, jc, key)
    pv, pnu = P.stale_read(ps, pc, np.asarray(key))
    np.testing.assert_array_equal(pnu, np.asarray(jnu))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_stale_read_bounded_staleness():
    jc, pc = cfgs()
    _, ps = pushed_states(jc, pc)
    v_hat, nu = P.stale_read(ps, pc, np.asarray(jax.random.PRNGKey(0)))
    assert int(nu.max()) <= pc.tau
    # every column is one of the last tau + 1 iterates
    assert set(v_hat[0].numpy() - np.arange(T)).issubset({3., 4., 5., 6.})


def test_probe_functions_match():
    _, pooled, tids, y = data()
    p = np.random.default_rng(1).standard_normal((D, T)).astype(np.float32)
    jp, jpool, jt, jy = map(jnp.asarray, (p, pooled, tids, y))
    tp, tpool, ttids, ty = tt(p, pooled, tids, y)
    assert rel(P.probe_predictions(tp, tpool, ttids),
               J.probe_predictions(jp, jpool, jt)) <= RTOL
    assert rel(P.probe_loss(tp, tpool, ttids, ty),
               J.probe_loss(jp, jpool, jt, jy)) <= RTOL
    assert rel(P.probe_task_grads(tp, tpool, ttids, ty),
               J.probe_task_grads(jp, jpool, jt, jy)) <= RTOL


def test_probe_grads_match_autodiff():
    """Column t of the analytic gradient is d loss_t / d p_t."""
    _, pooled, tids, y = data()
    p0 = torch.from_numpy(0.1 * np.random.default_rng(1).standard_normal(
        (D, T)).astype(np.float32))
    tpool, ttids, ty = tt(pooled, tids, y)
    onehot = torch.nn.functional.one_hot(ttids.long(), T).float()

    def per_task(p):
        r = P.probe_predictions(p, tpool, ttids) - ty
        return (r * r) @ onehot / torch.clamp(onehot.sum(0), min=1.0)

    auto = torch.autograd.functional.jacobian(per_task, p0)  # (T, D, T)
    analytic = P.probe_task_grads(p0, tpool, ttids, ty)
    for t in range(T):
        np.testing.assert_allclose(analytic[:, t].numpy(),
                                   auto[t, :, t].numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("dynamic,rate,reg", [
    (False, 1.0, "nuclear"), (True, 0.5, "nuclear"), (True, 0.5, "l21")])
def test_head_rounds_match(dynamic, rate, reg):
    """30 rounds with a stale read of their own: the draws, the counters
    and the metrics bitwise or to RTOL, the ring to RTOL."""
    jc, pc = cfgs(dynamic_step=dynamic, activation_rate=rate, reg_name=reg)
    _, pooled, tids, y = data(2, n=64)
    js, ps = J.init_mtl_state(D, jc), P.init_mtl_state(D, pc)
    tpool, ttids, ty = tt(pooled, tids, y)
    upd = jax.jit(lambda s, k: J.amtl_head_update(
        s, jnp.asarray(pooled), jnp.asarray(tids), jnp.asarray(y), jc, k))
    for i in range(30):
        key = jax.random.fold_in(jax.random.PRNGKey(1), i)
        js, jm = upd(js, key)
        ps, pm = P.amtl_head_update(ps, tpool, ttids, ty, pc,
                                    np.asarray(key))
        assert ps.ptr == int(js.ptr) and ps.step == int(js.step)
        np.testing.assert_array_equal(ps.delay_buf, np.asarray(js.delay_buf))
        np.testing.assert_array_equal(ps.delay_cnt, np.asarray(js.delay_cnt))
        assert pm["mtl_active_frac"] == np.float32(jm["mtl_active_frac"])
        assert pm["mtl_mean_staleness"] == np.float32(
            jm["mtl_mean_staleness"])
        np.testing.assert_allclose(float(pm["mtl_v_norm"]),
                                   float(jm["mtl_v_norm"]), rtol=RTOL)
        assert rel(ps.ring.numpy(), js.ring) <= RTOL, i
    assert rel(P.head_weights(ps, pc).numpy(), J.head_weights(js, jc)) \
        <= RTOL


def test_head_round_with_a_given_read_matches():
    """The train step's form: the read (p, nu) made outside, the mask from
    the round key's second half."""
    jc, pc = cfgs(dynamic_step=True, activation_rate=0.5)
    _, pooled, tids, y = data(3, n=32)
    js, ps = pushed_states(jc, pc, k=5)
    key = jax.random.PRNGKey(9)
    k_read, k_act = jax.random.split(key)
    jv, jnu = J.stale_read(js, jc, k_read)
    jp = jax.numpy.asarray(jv) * 0.5
    pv, pnu = P.stale_read(ps, pc, np.asarray(k_read))
    pp = pv * 0.5
    js2, jm = J.amtl_head_update(js, *map(jnp.asarray, (pooled, tids, y)),
                                 jc, k_act, read=(jp, jnu))
    ps2, pm = P.amtl_head_update(ps, *tt(pooled, tids, y), pc,
                                 np.asarray(k_act), read=(pp, pnu))
    want_mask = np.asarray(jax.random.bernoulli(
        jax.random.split(k_act)[1], pc.activation_rate, (T,)))
    np.testing.assert_array_equal(pm["mtl_mask"], want_mask)
    np.testing.assert_array_equal(pm["mtl_nu"], np.asarray(jnu))
    assert rel(ps2.ring.numpy(), js2.ring) <= RTOL
    # the state it was given is left as it was
    np.testing.assert_array_equal(ps.ring.numpy(), np.asarray(js.ring))


def test_head_converges_on_fixed_representation():
    """With frozen pooled features, repeated rounds drive the probe loss
    near the noise floor (Theorem 1 in the integrated setting)."""
    jc, pc = cfgs()
    _, pooled, tids, y = data(0, n=512)
    tpool, ttids, ty = tt(pooled, tids, y)
    state = P.init_mtl_state(D, pc)
    losses = []
    for i in range(400):
        key = np.asarray(jax.random.fold_in(jax.random.PRNGKey(1), i))
        state, _ = P.amtl_head_update(state, tpool, ttids, ty, pc, key)
        if i % 50 == 0:
            losses.append(float(P.probe_loss(P.head_weights(state, pc),
                                             tpool, ttids, ty)))
    assert losses[-1] < 0.05 * losses[0] and losses[-1] < 0.02


def test_nuclear_coupling_low_rank():
    """A strong lam collapses the head matrix toward low rank."""
    _, pc = cfgs(lam=3.0)
    _, pooled, tids, y = data(3, n=512)
    tpool, ttids, ty = tt(pooled, tids, y)
    state = P.init_mtl_state(D, pc)
    for i in range(300):
        key = np.asarray(jax.random.fold_in(jax.random.PRNGKey(4), i))
        state, _ = P.amtl_head_update(state, tpool, ttids, ty, pc, key)
    s = torch.linalg.svdvals(P.head_weights(state, pc))
    assert int((s > 1e-3 * s[0]).sum()) < T


def test_activation_mask_freezes_inactive_blocks():
    _, pc = cfgs(activation_rate=0.0)
    state = P.init_mtl_state(D, pc)
    _, pooled, tids, y = data(5)
    s2, m = P.amtl_head_update(state, *tt(pooled, tids, y), pc,
                               np.asarray(jax.random.PRNGKey(6)))
    assert not m["mtl_mask"].any()
    assert torch.equal(s2.ring[s2.ptr], state.ring[state.ptr])


def test_dynamic_step_sizes_match_reference_formula():
    jc, pc = cfgs(dynamic_step=True, tau=30)
    delays = np.array([0., 3., 12.5, 40.], np.float32)
    base = min(pc.km_relax, J.amtl_max_step(pc.tau, T, 0.99) * 3.0)
    want = np.asarray(base * J.dynamic_multiplier(jnp.asarray(delays))
                      / J.dynamic_multiplier(jnp.zeros(T)))
    got = P.step_sizes(pc, T, delays)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-7)
    flat = P.step_sizes(dataclasses.replace(pc, dynamic_step=False), T,
                        delays)
    assert (flat == np.float32(base)).all()
