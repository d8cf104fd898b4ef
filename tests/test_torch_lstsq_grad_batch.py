"""The full least-squares gradients of a batch in one call
(`ops.lstsq_grad_batch`, `ops.lstsq_grad_task`, `MTLProblem.task_grads`,
`full_grad`) and the kept rows of a minibatch (`ops.sample_rows`) on the
CPU: against the reference's `lstsq_grad` (its Pallas kernel in interpret
mode and its jnp path), its `task_grad` and `full_grad`, and against the
port's own earlier code path, in the engines.

Against JAX: GRAD_RTOL of 2|X|^T(|X||w| + |y| + 1), the tolerance of
tests/test_torch_losses_ragged.py (PyTorch and XLA or the Pallas body sum
the float32 contractions in another order).  Within the port: each row of
the batched call is the single event's gradient bit for bit, and on the
CPU every gradient keeps the bits of the composite 2 X^T (X w - y) the
engines ran before, so the engines' parity with JAX does not move.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.losses import MTLProblem as JProblem  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import losses, prng  # noqa: E402
from repro_torch.core.losses import MTLProblem  # noqa: E402
from repro_torch.interop import LEAVES, state_to_numpy  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import lstsq_grad as k_grad  # noqa: E402
from repro_torch.kernels import sample_mask as k_mask  # noqa: E402

GRAD_RTOL = 1e-5
N, D = 40, 24
COUNTS = (40, 17, 0, 33, 1, 16)          # n, ragged, empty, one row, a group
TASKS = (1, 3, 1, 2, 0, 4, 5, 1)         # duplicates, the empty task


def _problem(seed=0, counts=COUNTS):
    rng = np.random.default_rng(seed)
    t = len(counts)
    xs = rng.standard_normal((t, N, D)).astype(np.float32)
    ys = rng.standard_normal((t, N)).astype(np.float32)
    w = rng.standard_normal((len(TASKS), D)).astype(np.float32)
    return xs, ys, np.asarray(TASKS, np.int32), w


def _scale(x, w, y):
    ax = np.abs(x.astype(np.float64))
    return 2.0 * ax.T @ (ax @ np.abs(w) + np.abs(y) + 1.0)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _close(got, want, scale, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= GRAD_RTOL * scale + 1e-30).all(), (what, err.max())


def _counts(ragged):
    return torch.tensor(COUNTS, dtype=torch.int32) if ragged else None


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "jnp"])
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "uniform"])
def test_batch_ref_matches_jax_lstsq_grad(pallas, ragged):
    """Event by event against the reference's `lstsq_grad` (the Pallas body
    in interpret mode, or the jnp path), n_t from 0 to n."""
    xs, ys, tasks, w = _problem(1)
    got = ref.lstsq_grad_batch_ref(torch.from_numpy(xs), torch.from_numpy(ys),
                                   torch.from_numpy(tasks),
                                   torch.from_numpy(w), _counts(ragged))
    assert got.shape == (len(TASKS), D)
    for e, t in enumerate(tasks):
        n_t = jnp.int32(COUNTS[t]) if ragged else None
        want = jops.lstsq_grad(jnp.asarray(xs[t]), jnp.asarray(w[e]),
                               jnp.asarray(ys[t]), n_t=n_t,
                               use_pallas=pallas, interpret=pallas)
        _close(got[e], want, _scale(xs[t], w[e], ys[t]), (e, int(t)))
        if ragged and COUNTS[t] == 0:
            assert not _bits(got[e]).any()


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "uniform"])
def test_task_grads_match_jax_task_grad(ragged):
    xs, ys, tasks, w = _problem(2)
    rc = _counts(ragged)
    tp = MTLProblem(torch.from_numpy(xs), torch.from_numpy(ys), "lstsq",
                    "nuclear", 0.1, rc)
    jp = JProblem(jnp.asarray(xs), jnp.asarray(ys), "lstsq", "nuclear", 0.1,
                  None if rc is None else jnp.asarray(rc.numpy()))
    got = tp.task_grads(torch.from_numpy(tasks), torch.from_numpy(w))
    for e, t in enumerate(tasks):
        want = jp.task_grad(jnp.int32(t), jnp.asarray(w[e]))
        _close(got[e], want, _scale(xs[t], w[e], ys[t]), (e, int(t)))
        np.testing.assert_array_equal(
            _bits(got[e]), _bits(tp.task_grad(int(t), torch.from_numpy(w[e]))))


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "uniform"])
def test_batch_rows_are_the_single_call_bitwise(ragged):
    """Row e of the batched call is the task form, the batched form at
    B = 1 and the one-buffer form with the host count, bit for bit."""
    xs, ys, tasks, w = _problem(3)
    xt, yt, tt, wt = (torch.from_numpy(a) for a in (xs, ys, tasks, w))
    rc = _counts(ragged)
    rows = ops.lstsq_grad_batch(xt, yt, tt, wt, rc)
    for e, t in enumerate(tasks):
        n_t = COUNTS[t] if ragged else N
        for one in (ops.lstsq_grad_task(xt, yt, int(t), wt[e], rc),
                    ops.lstsq_grad_batch(xt, yt, tt[e:e + 1], wt[e:e + 1],
                                         rc)[0],
                    ops.lstsq_grad(xt[t], wt[e], yt[t], n_t)):
            np.testing.assert_array_equal(_bits(rows[e]), _bits(one))


def test_ids_outside_pick_the_reference_dynamic_index():
    """An id outside [0, T) picks the task that the reference's
    `lax.dynamic_index_in_dim` picks (a negative id counts from the end,
    then clamped), in the batched and the task form alike."""
    xs, ys, _, w = _problem(4)
    num_t = xs.shape[0]
    tasks = np.asarray((-1, 6, 9, -7, -2, 0, 3, -6), np.int32)
    picked = [ref.task_index(int(t), num_t) for t in tasks]
    assert picked == [5, 5, 5, 0, 4, 0, 3, 0]
    xt, yt, wt = torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(w)
    rc = _counts(True)
    got = ops.lstsq_grad_batch(xt, yt, torch.from_numpy(tasks), wt, rc)
    jp = JProblem(jnp.asarray(xs), jnp.asarray(ys), "lstsq", "nuclear", 0.1,
                  jnp.asarray(COUNTS, jnp.int32))
    for e, t in enumerate(tasks):
        jt = int(jax.lax.dynamic_index_in_dim(jnp.arange(num_t), jnp.int32(t),
                                              keepdims=False))
        assert jt == picked[e], (t, jt)
        want = jp.task_grad(jnp.int32(t), jnp.asarray(w[e]))
        _close(got[e], want, _scale(xs[jt], w[e], ys[jt]), int(t))
        np.testing.assert_array_equal(
            _bits(got[e]), _bits(ops.lstsq_grad_task(xt, yt, int(t), wt[e],
                                                     rc)))


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "uniform"])
def test_full_grad_matches_jax_and_keeps_the_composite_bits(ragged):
    """`full_grad` (one `task_grads` call over every task) against the
    reference's vmap, and bitwise the per-task composite it replaced."""
    xs, ys, _, _ = _problem(5)
    rng = np.random.default_rng(6)
    w = rng.standard_normal((D, len(COUNTS))).astype(np.float32)
    rc = _counts(ragged)
    tp = MTLProblem(torch.from_numpy(xs), torch.from_numpy(ys), "lstsq",
                    "nuclear", 0.1, rc)
    jp = JProblem(jnp.asarray(xs), jnp.asarray(ys), "lstsq", "nuclear", 0.1,
                  None if rc is None else jnp.asarray(rc.numpy()))
    wt = torch.from_numpy(w)
    got = tp.full_grad(wt)
    want = np.asarray(jp.full_grad(jnp.asarray(w)))
    assert got.shape == want.shape == (D, len(COUNTS))
    for t in range(len(COUNTS)):
        _close(got[:, t], want[:, t], _scale(xs[t], w[:, t], ys[t]), t)
    if rc is None:
        old = [losses.lstsq_grad(tp.xs[t], tp.ys[t], wt[:, t])
               for t in range(len(COUNTS))]
    else:
        old = [losses.lstsq_grad_masked(tp.xs[t], tp.ys[t], wt[:, t], rc[t])
               for t in range(len(COUNTS))]
    np.testing.assert_array_equal(_bits(got), _bits(torch.stack(old, dim=1)))
    for t in range(len(COUNTS)):
        np.testing.assert_array_equal(_bits(tp.task_grad(t, wt[:, t])),
                                      _bits(old[t]))


def test_task_grads_take_lstsq_only():
    xs, ys, tasks, w = _problem(7)
    p = MTLProblem(torch.from_numpy(xs), torch.from_numpy(ys), "logistic",
                   "nuclear", 0.1)
    with pytest.raises(ValueError, match="lstsq"):
        p.task_grads(torch.from_numpy(tasks), torch.from_numpy(w))


# ------------------------------------------------------ in the engines ---

ED, ET = 10, 5
OFFSETS = np.array([3.0, 1.0, 0.0, 2.0, 4.0], np.float32)
SIZES = (12, 30, 21, 4, 30)


def _engine_problem(ragged):
    rng = np.random.default_rng(0)
    if ragged:
        xs = [(rng.standard_normal((n, ED)) / np.sqrt(ED)).astype(np.float32)
              for n in SIZES]
        ys = [rng.standard_normal(n).astype(np.float32) for n in SIZES]
        return rt.stack_ragged(xs, ys, "lstsq", "nuclear", 0.1, device="cpu")
    xs = (rng.standard_normal((ET, 20, ED)) / np.sqrt(ED)).astype(np.float32)
    ys = rng.standard_normal((ET, 20)).astype(np.float32)
    return MTLProblem(torch.from_numpy(xs), torch.from_numpy(ys), "lstsq",
                      "nuclear", 0.1)


@pytest.fixture
def batched_calls(monkeypatch):
    """Counts the engine's calls of the batched full gradient."""
    calls = []
    real = MTLProblem.task_grads

    def spy(self, tasks, w_rows):
        calls.append(tasks.shape[0])
        return real(self, tasks, w_rows)
    monkeypatch.setattr(MTLProblem, "task_grads", spy)
    return calls


def _parent_grads(monkeypatch):
    """The engines' gradients as the parent tree computed them: the loss's
    composite a task at a time, the batch engine's loop of task_grad."""
    def task_grad(self, t, w_t):
        loss = losses.get_loss(self.loss_name)
        if self.row_counts is None:
            return loss.grad(self.xs[t], self.ys[t], w_t)
        return loss.grad_masked(self.xs[t], self.ys[t], w_t,
                                self.row_counts[t])

    def task_grads(self, tasks, w_rows):
        return torch.stack([task_grad(self, int(t), w_rows[i])
                            for i, t in enumerate(tasks.tolist())])
    monkeypatch.setattr(MTLProblem, "task_grad", task_grad)
    monkeypatch.setattr(MTLProblem, "task_grads", task_grads)


def _states_equal(a, b):
    for x, y, name in zip(state_to_numpy(a), state_to_numpy(b), LEAVES):
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("bsz,k,extra", [
    (4, 1, {}),
    (5, 2, dict(prox_rank=2, dynamic_step=True)),
])
@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "uniform"])
def test_batch_engine_takes_one_call_a_step_and_equals_delta_bitwise(
        batched_calls, ragged, bsz, k, extra):
    tp = _engine_problem(ragged)
    delta = rt.AMTLConfig(eta=1.0 / tp.lipschitz(), eta_k=0.7, tau=3,
                          engine="delta", prox_every=k * bsz, **extra)
    batch = delta._replace(engine="batch", event_batch=bsz)
    v0 = np.zeros((ED, ET), np.float32)
    key = prng.key_from_seed(3)
    n = 4 * k * bsz
    d = rt.amtl_events_only(tp, delta, v0, key, n, OFFSETS, device="cpu")
    assert batched_calls == []               # the delta engine: per event
    b = rt.amtl_events_only(tp, batch, v0, key, n, OFFSETS, device="cpu")
    assert batched_calls == [bsz] * (n // bsz)
    for x, y, name in zip(state_to_numpy(d), state_to_numpy(b), LEAVES):
        if name == "p_cache" and k == 1:
            continue              # delta carries a cache; aligned batch not
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("engine,ragged", [
    ("batch", True), ("batch", False), ("delta", True), ("delta", False),
    ("dense", False)],       # the dense engine refuses ragged problems
    ids=["batch-ragged", "batch-uniform", "delta-ragged", "delta-uniform",
         "dense-uniform"])
def test_engines_keep_the_parent_bits(monkeypatch, engine, ragged):
    """The CPU engines' states are bitwise those of the parent's gradient
    code path (the composite a task at a time) on the same inputs."""
    tp = _engine_problem(ragged)
    cfg = rt.AMTLConfig(eta=1.0 / tp.lipschitz(), eta_k=0.7, tau=3,
                        engine=engine,
                        event_batch=4 if engine == "batch" else 1,
                        prox_every=4 if engine == "batch" else 1)
    v0 = np.full((ED, ET), 0.01, np.float32)
    key = prng.key_from_seed(5)
    now = rt.amtl_events_only(tp, cfg, v0, key, 24, OFFSETS, device="cpu")
    with monkeypatch.context() as m:
        _parent_grads(m)
        before = rt.amtl_events_only(tp, cfg, v0, key, 24, OFFSETS,
                                     device="cpu")
    if engine == "dense":
        np.testing.assert_array_equal(_bits(now.ring), _bits(before.ring))
    else:
        _states_equal(now, before)


def test_fista_keeps_the_parent_bits(monkeypatch):
    tp = _engine_problem(False)._replace(reg_name="l21")
    w0 = torch.zeros((ED, ET))
    now = rt.fista_solve(tp, w0, 0.05, 6, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(MTLProblem, "full_grad", lambda self, w: torch.stack(
            self._per_task("grad", w), dim=1))
        before = rt.fista_solve(tp, w0, 0.05, 6, device="cpu")
    np.testing.assert_array_equal(_bits(now.w), _bits(before.w))
    np.testing.assert_array_equal(_bits(now.objectives),
                                  _bits(before.objectives))


# ------------------------------------------------------- sample_rows ---

@pytest.mark.parametrize("b,n_t", [(5, 40), (5, 17), (5, 0), (50, 33)],
                         ids=["uniform", "ragged", "empty", "saturated"])
def test_sample_rows_is_where_keep_bits_and_jax_x_s(b, n_t):
    rng = np.random.default_rng(b + n_t)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x[3] = -0.0                                  # a row of negative zeros
    seed = 0xFFFFFFF0 - n_t
    block = ref.sample_scalars(N, b, [seed], [n_t])[0]
    got = ops.sample_rows(torch.from_numpy(x), block)
    keep = ref.keep_bits_ref(N, block)
    np.testing.assert_array_equal(
        _bits(got), _bits(torch.where(keep[:, None], torch.from_numpy(x),
                                      0.0)))
    mask = jref.sample_mask_masked_ref(N, b, jnp.uint32(seed),
                                       jnp.int32(n_t))
    x_s = jnp.where(mask[:, None], jnp.asarray(x), 0.0)
    np.testing.assert_array_equal(_bits(got), _bits(x_s))
    assert int(got.any(dim=1).sum()) <= min(b, n_t)


def test_logistic_minibatch_gradient_keeps_its_bits():
    """`task_grad_sampled` of a non-lstsq loss takes its rows from
    `ops.sample_rows`: the bits of the keep bits then torch.where."""
    rng = np.random.default_rng(9)
    xs = torch.from_numpy(rng.standard_normal((2, N, D)).astype(np.float32))
    ys = torch.from_numpy(np.sign(rng.standard_normal((2, N)))
                          .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    p = MTLProblem(xs, ys, "logistic", "nuclear", 0.1,
                   torch.tensor([40, 23], dtype=torch.int32))
    for t, n_t in ((0, 40), (1, 23)):
        block = ref.sample_scalars(N, 6, [77 + t], [n_t])[0]
        x_s = torch.where(ops.sample_mask(N, block, "cpu")[:, None], xs[t],
                          0.0)
        bsz = min(6, n_t)
        scale = float(np.float32(n_t) / np.float32(bsz))
        want = scale * losses.logistic_grad(x_s, ys[t], w)
        np.testing.assert_array_equal(
            _bits(p.task_grad_sampled(t, w, block, 6)), _bits(want))


# ------------------------------------------- the wrappers refuse early ---

def _grad_args():
    xs, ys, tasks, w = _problem(8)
    return dict(xs=torch.from_numpy(xs), ys=torch.from_numpy(ys),
                tasks=torch.from_numpy(tasks), w_rows=torch.from_numpy(w),
                row_counts=_counts(True))


@pytest.mark.parametrize("change,match", [
    ({}, "CUDA"),
    (dict(xs=lambda a: a["xs"].double()), "float32"),
    (dict(w_rows=lambda a: a["w_rows"].half()), "float32"),
    (dict(tasks=lambda a: a["tasks"].long()), "int32"),
    (dict(row_counts=lambda a: a["row_counts"].long()), "int32"),
    (dict(xs=lambda a: a["xs"][0]), r"\(T, n, d\)"),
    (dict(ys=lambda a: a["ys"][:, :-1]), "ys must be"),
    (dict(row_counts=lambda a: a["row_counts"][:-1]), "row_counts"),
    (dict(w_rows=lambda a: a["w_rows"][:, :-1]), "w_rows"),
    (dict(tasks=lambda a: a["tasks"][None]), r"\(B,\)"),
    (dict(tasks=lambda a: a["tasks"][:0], w_rows=lambda a: a["w_rows"][:0]),
     "B = 0"),
    (dict(xs=lambda a: torch.zeros(6, 2, k_grad.MAX_D + 4),
          ys=lambda a: torch.zeros(6, 2),
          w_rows=lambda a: torch.zeros(len(TASKS), k_grad.MAX_D + 4)),
     "d must be"),
], ids=["cpu", "xs-f64", "w-f16", "tasks-i64", "counts-i64", "xs-2d",
        "ys-shape", "counts-shape", "w-shape", "tasks-2d", "empty",
        "d-too-wide"])
def test_batch_wrapper_refuses_without_building(monkeypatch, change, match):
    def no_build(*a, **kw):
        raise AssertionError("the kernels were built")
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "_lib", None)
    args_ = _grad_args()
    args_.update({k: f(args_) for k, f in change.items()})
    with pytest.raises(ValueError, match=match):
        k_grad.lstsq_grad_batch(**args_)


@pytest.mark.parametrize("call,match", [
    (lambda a: k_grad.lstsq_grad_task(a["xs"], a["ys"], 1, a["w_rows"][0],
                                      a["row_counts"]), "CUDA"),
    (lambda a: k_grad.lstsq_grad_task(a["xs"], a["ys"], 1.0, a["w_rows"][0]),
     "host integer"),
    (lambda a: k_grad.lstsq_grad_task(a["xs"], a["ys"], 2**31,
                                      a["w_rows"][0]), "int32"),
    (lambda a: k_grad.lstsq_grad_task(a["xs"], a["ys"], 1,
                                      a["w_rows"][0, :-1]), "w must be"),
    (lambda a: k_grad.lstsq_grad_task(a["xs"], a["ys"], 1,
                                      a["w_rows"][0].double()), "float32"),
    (lambda a: k_grad.lstsq_grad(a["xs"][0], a["w_rows"][0], a["ys"][0], 7),
     "CUDA"),
    (lambda a: k_grad.lstsq_grad(a["xs"][0], a["w_rows"][0], a["ys"][0], N + 1),
     "n_t"),
    (lambda a: k_mask.sample_rows(a["xs"][0], (1, 2, 3, 8)), "CUDA"),
    (lambda a: k_mask.sample_rows(a["xs"], (1, 2, 3, 8)), r"\(n, d\)"),
    (lambda a: k_mask.sample_rows(a["xs"][0].double(), (1, 2, 3, 8)),
     "float32"),
    (lambda a: k_mask.sample_rows(a["xs"][0], (1, 2, 3)), "scalar block"),
], ids=["task-cpu", "task-float-id", "task-id-too-big", "task-w-shape",
        "task-w-f64", "one-buffer-cpu", "one-buffer-n_t", "rows-cpu",
        "rows-3d", "rows-f64", "rows-block"])
def test_other_wrappers_refuse_without_building(monkeypatch, call, match):
    def no_build(*a, **kw):
        raise AssertionError("the kernels were built")
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(ValueError, match=match):
        call(_grad_args())


def test_wrapper_constants_are_the_kernel_s():
    """The scratch and counters are sized by the kernel's group rows and
    cluster, which fix the order of its sums."""
    src = (_build.CSRC / "lstsq_grad.cu").read_text()
    for name, value in (("kGroupRows", k_grad.GROUP_ROWS),
                        ("kCluster", k_grad.CLUSTER)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


def test_phase_variants_find_their_markers():
    """launch/grad_kernel_phases.py cuts the kernel by its source text:
    every variant differs from the kernel, and the spans variant times a
    block's end on both of its ways out."""
    from repro_torch.launch import grad_kernel_phases as phases
    srcs = phases.variants()
    src = (_build.CSRC / "lstsq_grad.cu").read_text()
    assert srcs["grad_full"] == src
    for name in ("grad_no_tail", "grad_no_cluster_sum", "grad_no_rows",
                 "grad_empty", "grad_spans"):
        assert srcs[name] != src, name
    assert srcs["grad_spans"].count("globaltimer") == 3
