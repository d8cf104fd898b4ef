"""The port's host replay of the threefry2x32 event chain against the
reference's `jax.random` draws, bit for bit.

Over 10**4 events a jitted scan of the reference's `_sample_activation`
(with `_minibatch_seed` and the sketch seed `bits(fold_in(key, 7))` taken
off each pre-event key) is held against the port's sequential replay:
task, staleness, next key, minibatch seed and sketch seed must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import amtl as jamtl  # noqa: E402
from repro.core.amtl import AMTLConfig as JConfig  # noqa: E402
from repro_torch.core import amtl, prng  # noqa: E402
from repro_torch.core.amtl import AMTLConfig  # noqa: E402
from repro.core.dynamic_step import DelayHistory as JHistory  # noqa: E402
from repro_torch.core.dynamic_step import DelayHistory  # noqa: E402

N_EVENTS = 10_000


def _jax_stream(cfg, offsets, key, num_tasks, event0, n):
    def one(k, i):
        mb = jamtl._minibatch_seed(k)
        sk = jax.random.bits(jax.random.fold_in(k, 7), dtype=jnp.uint32)
        k2, t, nu = jamtl._sample_activation(cfg, offsets, k, num_tasks,
                                             event0 + i)
        return k2, (t, nu, mb, sk, k2)

    run = jax.jit(lambda k: jax.lax.scan(one, k, jnp.arange(n)))
    _, out = run(key)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("tau,jitter,num_tasks,event0,seed", [
    (4, 1.0, 5, 0, 0),
    (8, 2.5, 128, 37, 11),
    (0, 0.37, 7, 0, 3),
    (16, 3.3, 1000, 123456, 2**31 - 1),
])
def test_event_stream_bitwise(tau, jitter, num_tasks, event0, seed):
    rng = np.random.default_rng(seed % 97)
    offsets = (rng.random(num_tasks) * (tau + 2)).astype(np.float32)
    offsets[0] = 1.5                            # an exact .5 for the rounding
    kw = dict(eta=0.1, eta_k=0.5, tau=tau, delay_jitter=jitter)
    key = jax.random.PRNGKey(seed)
    ts, nus, mbs, sks, keys = _jax_stream(JConfig(**kw), jnp.asarray(offsets),
                                          key, num_tasks, event0, N_EVENTS)

    cfg = AMTLConfig(**kw)
    pair = prng.to_pair(np.asarray(key))
    got = {"t": [], "nu": [], "mb": [], "sk": [], "key": []}
    for i in range(N_EVENTS):
        got["mb"].append(prng.bits_pair(prng.fold_in_pair(pair, 11)))
        got["sk"].append(prng.bits_pair(prng.fold_in_pair(pair, 7)))
        pair, t, nu = amtl._sample_pair(cfg, offsets, pair, num_tasks,
                                        event0 + i)
        got["t"].append(t)
        got["nu"].append(nu)
        got["key"].append(pair)
    np.testing.assert_array_equal(np.asarray(got["t"]), ts)
    np.testing.assert_array_equal(np.asarray(got["nu"]), nus)
    np.testing.assert_array_equal(np.asarray(got["mb"], np.uint32), mbs)
    np.testing.assert_array_equal(np.asarray(got["sk"], np.uint32), sks)
    np.testing.assert_array_equal(np.asarray(got["key"], np.uint32), keys)


@pytest.mark.parametrize("batch,event0", [(1, 0), (32, 5), (7, 1000)])
def test_sample_activation_batch_bitwise(batch, event0):
    offsets = np.array([3.0, 1.0, 0.0, 2.0, 4.5], np.float32)
    kw = dict(eta=0.1, eta_k=0.5, tau=4, delay_jitter=1.7)
    key = jax.random.PRNGKey(event0 + 1)
    want = jax.jit(lambda k: jamtl._sample_activation_batch(
        JConfig(**kw), jnp.asarray(offsets), k, 5, jnp.int32(event0),
        batch))(key)
    got = amtl._sample_activation_batch(AMTLConfig(**kw), offsets,
                                        np.asarray(key), 5, event0, batch)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g)


def test_single_draw_functions_bitwise():
    """split / fold_in / bits / randint / uniform / PRNGKey one by one."""
    for seed in (0, 3, 12345, 2**31 - 1, -7):
        key = jax.random.PRNGKey(seed)
        kk = prng.key_from_seed(seed)
        np.testing.assert_array_equal(np.asarray(key), kk)
        np.testing.assert_array_equal(np.asarray(jax.random.split(key, 3)),
                                      np.stack(prng.split(kk, 3)))
        for data in (0, 7, 11, 2**32 - 1):
            np.testing.assert_array_equal(
                np.asarray(jax.random.fold_in(key, data)),
                prng.fold_in(kk, data))
        assert int(jax.random.bits(key, dtype=jnp.uint32)) == prng.bits(kk)
        for hi in (1, 2, 5, 128, 1000, 2**20, 2**31 - 1):
            assert int(jax.random.randint(key, (), 0, hi)) \
                == prng.randint(kk, 0, hi)
        u = np.asarray(jax.random.uniform(key))
        assert u.dtype == prng.uniform(kk).dtype and u == prng.uniform(kk)


def test_sample_activation_numpy_api_matches_pair_api():
    cfg = AMTLConfig(eta=0.1, eta_k=0.5, tau=3)
    offs = np.zeros(4, np.float32)
    key = prng.key_from_seed(5)
    k2, t, nu = amtl._sample_activation(cfg, offs, key, 4, 2)
    p2, t2, nu2 = amtl._sample_pair(cfg, offs, prng.to_pair(key), 4, 2)
    assert (t, nu) == (t2, nu2)
    np.testing.assert_array_equal(k2, prng.to_key(p2))
    assert amtl._minibatch_seed(key) == int(jamtl._minibatch_seed(
        jnp.asarray(key)))


@pytest.mark.parametrize("dynamic", [False, True])
def test_km_relaxation_matches(dynamic):
    """History records bitwise, eta_k to a float32 ulp (numpy's and XLA's
    float32 log may round apart in the dynamic multiplier)."""
    kw = dict(eta=0.1, eta_k=0.3, tau=30, dynamic_step=dynamic)
    jcfg, tcfg = JConfig(**kw), AMTLConfig(**kw)
    jh, th = JHistory.create(4, 5), DelayHistory.create(4, 5)
    relax = jax.jit(lambda h, t, nu: jamtl._km_relaxation(jcfg, h, t, nu))
    rng = np.random.default_rng(1)
    for t, nu in zip(rng.integers(0, 4, 50), rng.integers(0, 31, 50)):
        jh, jk = relax(jh, jnp.int32(t), jnp.int32(nu))
        th, tk = amtl._km_relaxation(tcfg, th, int(t), int(nu))
        np.testing.assert_array_equal(th.buf, np.asarray(jh.buf))
        np.testing.assert_array_equal(th.count, np.asarray(jh.count))
        assert tk.dtype == np.float32
        np.testing.assert_allclose(tk, np.asarray(jk), rtol=2e-7)
