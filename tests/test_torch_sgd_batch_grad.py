"""The batch's minibatch gradients in one call
(`ops.lstsq_grad_sampled_batch`, `MTLProblem.task_grads_sampled`) on the
CPU, against the reference's Pallas kernel (interpret mode) and the port's
own single-event gradient, and in the batch SGD engine.

Against JAX: GRAD_RTOL of 2|X|^T(|X||w| + |y| + 1), the tolerance of
tests/test_torch_losses_ragged.py (PyTorch and the Pallas body sum the
float32 contractions in another order).  Within the port: each row of the
batched call is the single event's gradient bit for bit, so the batch SGD
engine stays bitwise the delta engine at a matched cadence.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import amtl as jamtl  # noqa: E402
from repro.data import stack_ragged as jstack  # noqa: E402
from repro.kernels.lstsq_grad_sampled import lstsq_grad_sampled as jgrad  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.losses import MTLProblem  # noqa: E402
from repro_torch.interop import LEAVES, state_to_numpy  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import lstsq_grad_sampled as k_sampled  # noqa: E402

GRAD_RTOL = 1e-5
ENGINE_RTOL = 1e-4
N, D = 40, 24
N_TS = (40, 17, 0, 33, 1)               # ragged, one empty, one of a row
TASKS = (1, 3, 1, 2, 0, 4, 1, 3)        # duplicates, the empty task
SEEDS = (9, 0xFFFFFFF0, 77, 5, 123456, 3, 9, 2**31)


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    t = len(N_TS)
    xs = rng.standard_normal((t, N, D)).astype(np.float32)
    ys = rng.standard_normal((t, N)).astype(np.float32)
    w = rng.standard_normal((len(TASKS), D)).astype(np.float32)
    tasks = np.asarray(TASKS, np.int32)
    scal = ref.sample_scalars(N, b, SEEDS, np.asarray(N_TS)[tasks])
    return xs, ys, tasks, w, scal


def _torch(xs, ys, tasks, w, scal):
    return (torch.from_numpy(xs), torch.from_numpy(ys),
            torch.from_numpy(tasks), torch.from_numpy(w),
            torch.from_numpy(scal))


def _scale(x, w, y):
    ax = np.abs(x.astype(np.float64))
    return 2.0 * ax.T @ (ax @ np.abs(w) + np.abs(y) + 1.0)


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("b", [1, 5, 17, 40])
def test_batch_ref_matches_pallas_interpret(b):
    """Event by event against the reference kernel's Pallas body: b < n_t,
    b >= n_t (saturated), n_t = 0 (exactly zero)."""
    xs, ys, tasks, w, scal = _batch(b, seed=b)
    got = ref.lstsq_grad_sampled_batch_ref(*_torch(xs, ys, tasks, w, scal),
                                           b).numpy()
    assert got.shape == (len(TASKS), D)
    for e, t in enumerate(tasks):
        want = jgrad(jnp.asarray(xs[t]), jnp.asarray(w[e]),
                     jnp.asarray(ys[t]), jnp.uint32(SEEDS[e]), batch_size=b,
                     n_t=jnp.int32(N_TS[t]), interpret=True)
        err = np.abs(got[e].astype(np.float64) - np.asarray(want, np.float64))
        assert (err <= GRAD_RTOL * _scale(xs[t], w[e], ys[t]) + 1e-30).all(), \
            (b, e, err.max())
        if N_TS[t] == 0:
            assert not got[e].any()


@pytest.mark.parametrize("b", [1, 5, 40])
def test_batch_rows_are_the_single_event_gradient_bitwise(b):
    xs, ys, tasks, w, scal = _batch(b, seed=10 + b)
    args_ = _torch(xs, ys, tasks, w, scal)
    rows = ops.lstsq_grad_sampled_batch(*args_, b)
    np.testing.assert_array_equal(
        _bits(rows), _bits(ref.lstsq_grad_sampled_batch_ref(*args_, b)))
    for e, t in enumerate(tasks):
        one = ops.lstsq_grad_sampled(args_[0][t], args_[3][e], args_[1][t],
                                     scal[e], b)
        np.testing.assert_array_equal(_bits(rows[e]), _bits(one))


def test_batch_ids_outside_pick_the_reference_dynamic_index():
    """An id outside [0, T) picks the task that the reference's
    `lax.dynamic_index_in_dim` picks (a negative id counts from the end,
    then clamped), on the plain version as in the kernel."""
    b = 5
    xs, ys, _, w, _ = _batch(b, seed=21)
    num_t = xs.shape[0]
    tasks = np.asarray((-1, 5, 7, -6, -2, 0, 9, -5), np.int32)
    picked = [ref.task_index(int(t), num_t) for t in tasks]
    assert picked == [4, 4, 4, 0, 3, 0, 4, 0]
    scal = ref.sample_scalars(N, b, SEEDS, np.asarray(N_TS)[picked])
    got = ref.lstsq_grad_sampled_batch_ref(*_torch(xs, ys, tasks, w, scal),
                                           b).numpy()
    for e, t in enumerate(tasks):
        def pick(a, t=t):
            return jax.lax.dynamic_index_in_dim(jnp.asarray(a), jnp.int32(t),
                                                keepdims=False)
        jt = int(pick(np.arange(num_t)))
        assert jt == picked[e], (t, jt)
        want = jgrad(pick(xs), jnp.asarray(w[e]), pick(ys),
                     jnp.uint32(SEEDS[e]), batch_size=b,
                     n_t=jnp.int32(N_TS[jt]), interpret=True)
        err = np.abs(got[e].astype(np.float64) - np.asarray(want, np.float64))
        assert (err <= GRAD_RTOL * _scale(xs[jt], w[e], ys[jt])
                + 1e-30).all(), (t, err.max())
        np.testing.assert_array_equal(_bits(got[e]), _bits(
            ref.lstsq_grad_sampled_masked_ref(
                torch.from_numpy(xs[jt]), torch.from_numpy(w[e]),
                torch.from_numpy(ys[jt]), SEEDS[e], b, N_TS[jt])))


def test_task_grads_sampled_is_the_per_event_loop_bitwise():
    xs, ys, tasks, w, scal = _batch(5, seed=3)
    xt, yt, tt, wt, st = _torch(xs, ys, tasks, w, scal)
    p = MTLProblem(xt, yt, "lstsq", "nuclear", 0.1,
                   torch.tensor(N_TS, dtype=torch.int32))
    got = p.task_grads_sampled(tt, wt, st, 5)
    for e, t in enumerate(tasks):
        np.testing.assert_array_equal(
            _bits(got[e]),
            _bits(p.task_grad_sampled(int(t), wt[e], scal[e], 5)))
    with pytest.raises(ValueError, match="lstsq"):
        p._replace(loss_name="logistic").task_grads_sampled(tt, wt, st, 5)


# ------------------------------------------------- the batch SGD engine ---

SIZES = (12, 30, 21, 4, 30)
ED = 10
OFFSETS = np.array([3.0, 1.0, 0.0, 2.0, 4.0], np.float32)


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(0)
    xs = [(rng.standard_normal((n, ED)) / np.sqrt(ED)).astype(np.float32)
          for n in SIZES]
    ys = [rng.standard_normal(n).astype(np.float32) for n in SIZES]
    return (jstack(xs, ys, "lstsq", "nuclear", 0.1),
            rt.stack_ragged(xs, ys, "lstsq", "nuclear", 0.1, device="cpu"))


@pytest.fixture
def batched_calls(monkeypatch):
    """Counts the engine's calls of the batched gradient."""
    calls = []
    real = ops.lstsq_grad_sampled_batch

    def spy(*a, **kw):
        calls.append(a[2].shape[0])
        return real(*a, **kw)
    monkeypatch.setattr(ops, "lstsq_grad_sampled_batch", spy)
    return calls


@pytest.mark.parametrize("bsz,k,extra", [
    (4, 1, dict(batch_size=5)),
    (5, 2, dict(batch_size=1, dynamic_step=True, prox_rank=2)),
    (2, 3, dict(batch_size=40)),
])
def test_batch_engine_takes_one_call_a_step_and_equals_delta_bitwise(
        problems, batched_calls, bsz, k, extra):
    _, tp = problems
    delta = rt.AMTLConfig(eta=1.0 / tp.lipschitz(), eta_k=0.7, tau=3,
                          engine="delta", prox_every=k * bsz, **extra)
    batch = delta._replace(engine="batch", event_batch=bsz)
    v0 = np.zeros((ED, len(SIZES)), np.float32)
    key = prng.key_from_seed(3)
    n = 4 * k * bsz
    d = rt.amtl_events_only(tp, delta, v0, key, n, OFFSETS, device="cpu")
    assert batched_calls == []               # the delta engine: per event
    b = rt.amtl_events_only(tp, batch, v0, key, n, OFFSETS, device="cpu")
    assert batched_calls == [bsz] * (n // bsz)
    for a, c, name in zip(state_to_numpy(d), state_to_numpy(b), LEAVES):
        if name == "p_cache" and k == 1:
            continue              # delta carries a cache; aligned batch not
        np.testing.assert_array_equal(a, c, err_msg=name)


@pytest.mark.parametrize("case", [
    dict(event_batch=4, prox_every=4, batch_size=8),
    dict(event_batch=4, prox_every=8, prox_rank=2, batch_size=3, tau=4),
])
def test_batch_engine_matches_jax(problems, batched_calls, case):
    jp, tp = problems
    kw = {"eta": 1.0 / jp.lipschitz(), "eta_k": 0.7, "tau": 3,
          "engine": "batch", **case}
    key = jax.random.PRNGKey(21)
    v0 = np.full((ED, len(SIZES)), 0.01, np.float32)
    je = jamtl.make_engine(jp, jamtl.AMTLConfig(**kw))
    te = rt.make_engine(tp, rt.AMTLConfig(**kw), device="cpu")
    n = 64
    js = je.run(je.init(jnp.asarray(v0), key), jnp.asarray(OFFSETS), n)
    ts = te.run(te.init(v0, np.asarray(key)), OFFSETS, n)
    assert len(batched_calls) == n // case["event_batch"]
    want = dict(zip(LEAVES, (np.asarray(a) for a in
                             jax.tree_util.tree_leaves(js))))
    mine = dict(zip(LEAVES, state_to_numpy(ts)))
    for f in ("task_ring", "ptr", "event", "history.buf", "history.count",
              "key"):
        np.testing.assert_array_equal(mine[f], want[f], err_msg=f)
    for f in ("v", "delta_ring", "p_cache"):
        ref_f = want[f].astype(np.float64)
        scale = max(np.abs(ref_f).max(initial=0.0), 1e-30)
        assert np.abs(mine[f] - ref_f).max(initial=0.0) <= ENGINE_RTOL * scale


def test_logistic_batch_engine_keeps_the_per_event_loop(problems,
                                                       batched_calls):
    _, tp = problems
    lp = tp._replace(ys=torch.where(tp.ys > 0, 1.0, -1.0),
                     loss_name="logistic")
    cfg = rt.AMTLConfig(eta=0.1, eta_k=0.7, tau=3, engine="batch",
                        event_batch=4, prox_every=4, batch_size=3)
    rt.amtl_events_only(lp, cfg, np.zeros((ED, len(SIZES)), np.float32),
                        prng.key_from_seed(1), 16, OFFSETS, device="cpu")
    assert batched_calls == []


# ------------------------------------------- the wrapper refuses early ---

def _valid():
    xs, ys, tasks, w, scal = _batch(5)
    return dict(xs=torch.from_numpy(xs), ys=torch.from_numpy(ys),
                tasks=torch.from_numpy(tasks), w_rows=torch.from_numpy(w),
                scalars=torch.from_numpy(scal), batch_size=5)


@pytest.mark.parametrize("change,match", [
    ({}, "CUDA"),
    (dict(xs=lambda a: a["xs"].double()), "float32"),
    (dict(w_rows=lambda a: a["w_rows"].half()), "float32"),
    (dict(tasks=lambda a: a["tasks"].long()), "int32"),
    (dict(scalars=lambda a: a["scalars"].view(torch.int32)), "uint32"),
    (dict(xs=lambda a: a["xs"][0]), r"\(T, n, d\)"),
    (dict(ys=lambda a: a["ys"][:, :-1]), "ys must be"),
    (dict(w_rows=lambda a: a["w_rows"][:, :-1]), "w_rows"),
    (dict(scalars=lambda a: a["scalars"][:-1]), "scalars"),
    (dict(tasks=lambda a: a["tasks"][:0], w_rows=lambda a: a["w_rows"][:0],
          scalars=lambda a: a["scalars"][:0]), "B = 0"),
    (dict(batch_size=lambda a: 0), "batch_size"),
    (dict(xs=lambda a: torch.zeros(1, 2, k_sampled.MAX_D + 4),
          ys=lambda a: torch.zeros(1, 2),
          w_rows=lambda a: torch.zeros(len(TASKS), k_sampled.MAX_D + 4)),
     "d must be"),
], ids=["cpu", "xs-f64", "w-f16", "tasks-i64", "scalars-i32", "xs-2d",
        "ys-shape", "w-shape", "scalars-shape", "empty", "batch_size",
        "d-too-wide"])
def test_batch_wrapper_refuses_without_building(monkeypatch, change, match):
    def no_build(*a, **kw):
        raise AssertionError("the kernels were built")
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "_lib", None)
    args_ = _valid()
    args_.update({k: f(args_) for k, f in change.items()})
    with pytest.raises(ValueError, match=match):
        k_sampled.lstsq_grad_sampled_batch(**args_)


def test_phase_variants_find_their_markers():
    """launch/sgd_kernel_phases.py cuts the kernels by their source text:
    every variant differs from the kernel it cuts."""
    from repro_torch.launch import sgd_kernel_phases as phases
    grad = (_build.CSRC / "lstsq_grad_sampled.cu").read_text()
    batch = (_build.CSRC / "amtl_event_batch.cu").read_text()
    srcs = phases.variants()
    assert srcs["full"].startswith(grad)
    for name in ("wide", "narrow", "no_cluster_sum", "grad_spans"):
        assert srcs[name] != grad, name
    assert srcs["batch_spans"] != batch
    assert srcs["grad_spans"].count("globaltimer") == 2
    # the touched-column variant: no staged tile written back, each chain's
    # last value stored to its column of V
    cols = srcs["batch_columns_spans"]
    assert phases.TILE_WRITE_BACK in srcs["batch_spans"]
    assert phases.TILE_WRITE_BACK not in cols
    assert phases.COLUMN_STORE[0][1] in cols
    assert cols.count("globaltimer") == 2
