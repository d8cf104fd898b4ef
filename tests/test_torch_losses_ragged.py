"""The port's ragged losses, masked gradients and seeded-minibatch
gradients (`repro_torch.core.losses`, `repro_torch.kernels.ref`) against
the reference's, on the same numpy-seeded inputs, and the port's own
bitwise contracts on the CPU.

Against JAX: GRAD_RTOL of the sum of absolute products (PyTorch and XLA
sum the float32 contractions in another order; one rounding per term
bounds the difference); the Pallas kernels run in interpret mode.
Within the port: a saturated minibatch (batch_size >= n) IS the full
gradient, and row_counts == n IS the uniform problem, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.losses import MTLProblem as JProblem  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.losses import MTLProblem  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

GRAD_RTOL = 1e-5
SIZES = (12, 30, 21, 0, 30, 1)
N, D = 30, 10


def _data(loss, seed=0):
    rng = np.random.default_rng(seed)
    t = len(SIZES)
    xs = (rng.standard_normal((t, N, D)) / np.sqrt(D)).astype(np.float32)
    ys = rng.standard_normal((t, N)).astype(np.float32)
    if loss == "logistic":
        ys = np.where(ys > 0, 1.0, -1.0).astype(np.float32)
    w = rng.standard_normal((D, t)).astype(np.float32)
    return xs, ys, w


def _problems(loss, counts=SIZES, seed=0):
    xs, ys, w = _data(loss, seed)
    rc = None if counts is None else np.asarray(counts, np.int32)
    jp = JProblem(jnp.asarray(xs), jnp.asarray(ys), loss, "nuclear", 0.1,
                  None if rc is None else jnp.asarray(rc))
    tp = MTLProblem(torch.from_numpy(xs), torch.from_numpy(ys), loss,
                    "nuclear", 0.1, None if rc is None else torch.from_numpy(rc))
    return jp, tp, w


def _scale(x, w, y):
    """2 |X|^T (|X||w| + |y| + 1): bounds the sum of absolute products of
    either loss's gradient (the logistic weights are below 1)."""
    ax = np.abs(x.astype(np.float64))
    return 2.0 * ax.T @ (ax @ np.abs(w) + np.abs(y) + 1.0)


def _close(got, want, scale, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= GRAD_RTOL * scale + 1e-30).all(), (what, err.max())


@pytest.mark.parametrize("loss", ["lstsq", "logistic"])
@pytest.mark.parametrize("counts", [SIZES, None], ids=["ragged", "uniform"])
def test_masked_values_and_gradients_match_jax(loss, counts):
    jp, tp, w = _problems(loss, counts)
    wt = torch.from_numpy(w)
    xs, ys = np.asarray(jp.xs), np.asarray(jp.ys)
    full = tp.full_grad(wt).numpy()
    jfull = np.asarray(jp.full_grad(jnp.asarray(w)))
    for t in range(len(SIZES)):
        sc = _scale(xs[t], w[:, t], ys[t])
        _close(full[:, t], jfull[:, t], sc, f"full_grad {t}")
        _close(tp.task_grad(t, wt[:, t]).numpy(),
               np.asarray(jp.task_grad(t, jnp.asarray(w[:, t]))), sc,
               f"task_grad {t}")
    lv = float(tp.loss_value(wt))
    jlv = float(jp.loss_value(jnp.asarray(w)))
    assert abs(lv - jlv) <= GRAD_RTOL * abs(jlv), (lv, jlv)
    assert tp.lipschitz() == pytest.approx(jp.lipschitz(), rel=1e-12)


@pytest.mark.parametrize("loss", ["lstsq", "logistic"])
@pytest.mark.parametrize("counts", [SIZES, None], ids=["ragged", "uniform"])
@pytest.mark.parametrize("b", [1, 7, 30, 64])
def test_task_grad_sampled_matches_jax(loss, counts, b):
    jp, tp, w = _problems(loss, counts, seed=1)
    xs, ys = np.asarray(jp.xs), np.asarray(jp.ys)
    n_ts = tp.host_row_counts()
    for t in range(len(SIZES)):
        for seed in (3, 0xFFFFFFF0):
            block = ref.sample_scalars(N, b, [seed],
                                       None if counts is None else
                                       [n_ts[t]])[0]
            got = tp.task_grad_sampled(t, torch.from_numpy(w[:, t]), block, b)
            want = jp.task_grad_sampled(t, jnp.asarray(w[:, t]),
                                        jnp.uint32(seed), b)
            _close(got.numpy(), np.asarray(want),
                   _scale(xs[t], w[:, t], ys[t]), f"t={t} seed={seed}")


@pytest.mark.parametrize("b,n_t", [(5, 40), (5, 17), (40, 17), (50, 0),
                                   (3, 0), (1, 1), (39, 40)])
def test_lstsq_grad_sampled_matches_pallas_interpret(b, n_t):
    """n = 40, d = 24, through the reference kernel's Pallas body."""
    rng = np.random.default_rng(b * 100 + n_t)
    n, d = 40, 24
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    want = jops.lstsq_grad_sampled(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(y), jnp.uint32(9),
                                   batch_size=b, n_t=jnp.int32(n_t),
                                   use_pallas=True, interpret=True)
    block = ref.sample_scalars(n, b, [9], [n_t])[0]
    got = ops.lstsq_grad_sampled(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(y), block, b)
    _close(got.numpy(), np.asarray(want), _scale(x, w, y), (b, n_t))
    if n_t == 0:
        assert not got.any()


@pytest.mark.parametrize("n_t", [None, 0, 13, 40])
def test_lstsq_grad_matches_jax_ref_and_pallas(n_t):
    rng = np.random.default_rng(7)
    n, d = 40, 24
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    jx, jw, jy = jnp.asarray(x), jnp.asarray(w), jnp.asarray(y)
    nt = None if n_t is None else jnp.int32(n_t)
    got = ops.lstsq_grad(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(y), n_t).numpy()
    for want in (jops.lstsq_grad(jx, jw, jy, n_t=nt, use_pallas=False),
                 jops.lstsq_grad(jx, jw, jy, n_t=nt, use_pallas=True,
                                 interpret=True)):
        _close(got, np.asarray(want), _scale(x, w, y), n_t)


def test_sampled_refs_match_jax_refs():
    rng = np.random.default_rng(8)
    n, d = 37, 9
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    jx, jw, jy = jnp.asarray(x), jnp.asarray(w), jnp.asarray(y)
    tx, tw, ty = (torch.from_numpy(a) for a in (x, w, y))
    for b in (1, 8, 36, 37, 50):
        for seed in (0, 11):
            _close(ref.lstsq_grad_sampled_ref(tx, tw, ty, seed, b).numpy(),
                   np.asarray(jref.lstsq_grad_sampled_ref(
                       jx, jw, jy, jnp.uint32(seed), b)),
                   _scale(x, w, y), (b, seed))
            for n_t in (0, 5, 20, 37):
                _close(ref.lstsq_grad_sampled_masked_ref(
                    tx, tw, ty, seed, b, n_t).numpy(),
                    np.asarray(jref.lstsq_grad_sampled_masked_ref(
                        jx, jw, jy, jnp.uint32(seed), b, jnp.int32(n_t))),
                    _scale(x, w, y), (b, seed, n_t))


# ------------------------------------------------- bitwise, port on the CPU

@pytest.mark.parametrize("loss", ["lstsq", "logistic"])
def test_saturated_minibatch_is_the_full_gradient_bitwise(loss):
    """batch_size >= n: every valid row is kept and the scale is 1."""
    _, tp, w = _problems(loss, seed=2)
    n_ts = tp.host_row_counts()
    for b in (N, N + 5):
        for t in range(len(SIZES)):
            block = ref.sample_scalars(N, b, [t + 1], [n_ts[t]])[0]
            wt = torch.from_numpy(w[:, t])
            got = tp.task_grad_sampled(t, wt, block, b)
            torch.testing.assert_close(got, tp.task_grad(t, wt), rtol=0,
                                       atol=0)


@pytest.mark.parametrize("loss", ["lstsq", "logistic"])
@pytest.mark.parametrize("b", [4, 30])
def test_uniform_row_counts_are_the_uniform_problem_bitwise(loss, b):
    _, plain, w = _problems(loss, counts=None, seed=3)
    _, full, _ = _problems(loss, counts=(N,) * len(SIZES), seed=3)
    wt = torch.from_numpy(w)
    for p in (plain, full):
        assert (p.host_row_counts() == N).all()
    assert torch.equal(plain.loss_value(wt), full.loss_value(wt))
    assert torch.equal(plain.full_grad(wt), full.full_grad(wt))
    for t in range(len(SIZES)):
        a = ref.sample_scalars(N, b, [t + 7])[0]
        c = ref.sample_scalars(N, b, [t + 7], [N])[0]
        np.testing.assert_array_equal(a, c)
        assert torch.equal(plain.task_grad_sampled(t, wt[:, t], a, b),
                           full.task_grad_sampled(t, wt[:, t], c, b))
    # and the two plain versions of the sampled gradient, uniform vs masked
    x, y = plain.xs[1], plain.ys[1]
    assert torch.equal(ref.lstsq_grad_sampled_ref(x, wt[:, 1], y, 5, b),
                       ref.lstsq_grad_sampled_masked_ref(x, wt[:, 1], y, 5, b,
                                                         N))
