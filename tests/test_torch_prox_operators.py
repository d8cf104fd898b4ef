"""The port's prox, operators, losses and delay history against the
reference on the same numpy-seeded inputs.

Bitwise: the undo-log rollbacks (pure data movement) and the delay
history's records.  Tolerances, each with its reason at the constant:
the SVDs, QRs and matrix products of the two libraries round differently.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dynamic_step as jdyn  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core import prox as jprox  # noqa: E402
from repro.core.losses import MTLProblem as JProblem  # noqa: E402
from repro_torch.core import dynamic_step, operators, prox  # noqa: E402
from repro_torch.interop import problem_from_numpy  # noqa: E402

# float32 SVD/QR-based maps: a few ulps of the matrix's scale per entry,
# amplified by the conditioning of the thresholded spectrum.
PROX_ATOL = 1e-5
# Gradients and objectives: float32 matmuls summed in another order.
GRAD_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# jitted once per tau, so the (ptr, nu) sweeps reuse one executable
_j_rollback = jax.jit(jops.rollback_columns, static_argnums=5)
_j_rollback_batch = jax.jit(jops.rollback_columns_batch, static_argnums=5)
_j_rollback_shard = jax.jit(jops.rollback_columns_shard, static_argnums=5)


def _ring_case(seed, tau, num_t, d):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((d, num_t)).astype(np.float32)
    ring = rng.standard_normal((tau + 1, d)).astype(np.float32)
    tasks = rng.integers(0, num_t, tau + 1).astype(np.int32)
    return v, ring, tasks


@pytest.mark.parametrize("tau,num_t", [(0, 3), (1, 2), (4, 3), (8, 5),
                                       (6, 1)])
def test_rollbacks_bitwise(tau, num_t):
    """Every (ptr, nu) including ring wrap (ptr < nu) and nu = 0."""
    v, ring, tasks = _ring_case(tau * 10 + num_t, tau, num_t, 6)
    for ptr in range(tau + 1):
        for nu in range(tau + 1):
            want = np.asarray(_j_rollback(
                jnp.asarray(v), jnp.asarray(ring), jnp.asarray(tasks),
                jnp.int32(ptr), jnp.int32(nu), tau))
            want_b = np.asarray(_j_rollback_batch(
                jnp.asarray(v), jnp.asarray(ring), jnp.asarray(tasks),
                jnp.int32(ptr), jnp.int32(nu), tau))
            np.testing.assert_array_equal(want, want_b)
            got = operators.rollback_columns(_t(v), _t(ring), tasks, ptr, nu,
                                             tau)
            got_b = operators.rollback_columns_batch(_t(v), _t(ring), tasks,
                                                     ptr, nu, tau)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got_b.numpy(), want)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_rollback_shard_bitwise(n_shards):
    tau, num_t, d = 7, 8, 5
    v, ring, tasks = _ring_case(n_shards, tau, num_t, d)
    n_local = num_t // n_shards
    for ptr in (0, 3, 7):
        for nu in (0, 2, 7):
            for s in range(n_shards):
                off = s * n_local
                block = v[:, off:off + n_local]
                want = np.asarray(_j_rollback_shard(
                    jnp.asarray(block), jnp.asarray(ring), jnp.asarray(tasks),
                    jnp.int32(ptr), jnp.int32(nu), tau, jnp.int32(off)))
                got = operators.rollback_columns_shard(
                    _t(block), _t(ring), tasks, ptr, nu, tau, off)
                np.testing.assert_array_equal(got.numpy(), want)


def test_rollback_returns_new_tensor():
    v, ring, tasks = _ring_case(0, 3, 3, 4)
    vt = _t(v)
    out = operators.rollback_columns_batch(vt, _t(ring), tasks, 3, 3, 3)
    assert out is not vt
    np.testing.assert_array_equal(vt.numpy(), v)


@pytest.mark.parametrize("d,num_t,thresh", [(20, 5, 0.3), (50, 12, 2.0),
                                            (8, 8, 0.0)])
def test_svt_matches(d, num_t, thresh):
    rng = np.random.default_rng(d)
    w = rng.standard_normal((d, num_t)).astype(np.float32)
    want = np.asarray(jprox.svt(jnp.asarray(w), jnp.float32(thresh)))
    got = prox.svt(_t(w), thresh).numpy()
    np.testing.assert_allclose(got, want, atol=PROX_ATOL, rtol=0)


@pytest.mark.parametrize("d,num_t,rank", [(40, 10, 3), (64, 16, 16),
                                          (30, 6, 2)])
def test_svt_randomized_same_key(d, num_t, rank):
    """Same folded key => same sketch seed => the same thresholded
    reconstruction up to float32 rounding (the SVD/QR sign conventions
    cancel in U sigma V^T and Q U_b)."""
    rng = np.random.default_rng(d + rank)
    # a low-rank-plus-noise matrix, so the sketch captures the spectrum
    w = (rng.standard_normal((d, rank)) @ rng.standard_normal((rank, num_t))
         + 0.01 * rng.standard_normal((d, num_t))).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(d), 7)
    want = np.asarray(jprox.svt_randomized(jnp.asarray(w), jnp.float32(0.5),
                                           rank=rank, key=key))
    got = prox.svt_randomized(_t(w), 0.5, rank=rank,
                              key=np.asarray(key)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=PROX_ATOL * scale, rtol=0)


@pytest.mark.parametrize("name", ["nuclear", "l21", "l1", "elastic_net",
                                  "ridge", "none"])
def test_regularizers_match(name):
    rng = np.random.default_rng(1)
    w = (2.0 * rng.standard_normal((15, 6))).astype(np.float32)
    t = 0.7
    want = np.asarray(jprox.apply_prox(name, jnp.asarray(w), jnp.float32(t)))
    got = prox.apply_prox(name, _t(w), t).numpy()
    np.testing.assert_allclose(got, want, atol=PROX_ATOL, rtol=0)
    want_v = float(jprox.get_regularizer(name).value(jnp.asarray(w)))
    got_v = float(prox.get_regularizer(name).value(_t(w)))
    np.testing.assert_allclose(got_v, want_v, rtol=GRAD_RTOL, atol=1e-6)
    assert prox.sketch_width(5, 40, 10) == jprox.sketch_width(5, 40, 10)


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((4, 20, 9)).astype(np.float32)
    ys = rng.standard_normal((4, 20)).astype(np.float32)
    out = {}
    for loss in ("lstsq", "logistic"):
        yy = np.sign(ys) if loss == "logistic" else ys
        out[loss] = (JProblem(jnp.asarray(xs), jnp.asarray(yy), loss,
                              "nuclear", 0.1),
                     problem_from_numpy(xs, yy, loss, "nuclear", 0.1,
                                        device="cpu"))
    return out


@pytest.mark.parametrize("loss", ["lstsq", "logistic"])
def test_losses_grads_objective_lipschitz(problems, loss):
    jp, tp = problems[loss]
    rng = np.random.default_rng(9)
    w = rng.standard_normal((9, 4)).astype(np.float32)
    assert tp.lipschitz() == pytest.approx(jp.lipschitz(), rel=1e-12)
    np.testing.assert_allclose(tp.full_grad(_t(w)).numpy(),
                               np.asarray(jp.full_grad(jnp.asarray(w))),
                               rtol=GRAD_RTOL, atol=1e-5)
    np.testing.assert_allclose(
        tp.task_grad(2, _t(w[:, 2])).numpy(),
        np.asarray(jp.task_grad(jnp.int32(2), jnp.asarray(w[:, 2]))),
        rtol=GRAD_RTOL, atol=1e-5)
    np.testing.assert_allclose(float(tp.objective(_t(w))),
                               float(jp.objective(jnp.asarray(w))),
                               rtol=GRAD_RTOL)
    res_t = float(operators.fixed_point_residual(tp, _t(w), 0.01))
    res_j = float(jops.fixed_point_residual(jp, jnp.asarray(w), 0.01))
    np.testing.assert_allclose(res_t, res_j, rtol=1e-4)


def test_operators_and_step_cap():
    rng = np.random.default_rng(2)
    v, p, g = (rng.standard_normal(64).astype(np.float32) for _ in range(3))
    want = jax.jit(jops.km_block_update)(v, p, g, jnp.float32(0.05),
                                         jnp.float32(0.6))
    got = operators.km_block_update(_t(v), _t(p), _t(g), 0.05, 0.6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for tau, num_t in ((0, 1), (4, 5), (8, 128)):
        assert operators.amtl_max_step(tau, num_t) \
            == jops.amtl_max_step(tau, num_t)
    with pytest.raises(ValueError):
        operators.amtl_max_step(1, 4, c=1.0)


def test_delay_history_and_multiplier():
    """Records bitwise over a long random stream; the multiplier to a
    float32 ulp (numpy's and XLA's float32 log may round apart)."""
    rng = np.random.default_rng(4)
    jh = jdyn.DelayHistory.create(3, 5)
    th = dynamic_step.DelayHistory.create(3, 5)
    for t, nu in zip(rng.integers(0, 3, 60), rng.integers(0, 30, 60)):
        jh = jh.record(jnp.int32(t), jnp.float32(nu))
        th = th.record(int(t), nu)
        np.testing.assert_array_equal(th.buf, np.asarray(jh.buf))
        np.testing.assert_array_equal(th.count, np.asarray(jh.count))
        assert th.mean_delay(int(t)) == np.asarray(jh.mean_delay(jnp.int32(t)))
        np.testing.assert_allclose(
            dynamic_step.dynamic_multiplier(th.mean_delay(int(t))),
            np.asarray(jdyn.dynamic_multiplier(jh.mean_delay(jnp.int32(t)))),
            rtol=2e-7)
    np.testing.assert_array_equal(th.mean_delay_all(),
                                  np.asarray(jh.mean_delay_all()))
