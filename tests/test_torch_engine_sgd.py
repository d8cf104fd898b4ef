"""SGD-AMTL on ragged cohorts in the port's engine session
(`repro_torch.core.amtl` with `batch_size` and `row_counts`), on the CPU,
against the reference's JAX engines and its float64 simulator.

Against JAX, same ragged problem, same PRNGKey: the event stream and
every event's minibatch seed bitwise; `task_ring`, `ptr`, `event`,
`history` and `key` bitwise; `v`, `delta_ring` and `p_cache` to
ENGINE_RTOL of their scale (the minibatch gradients are float32 products
summed in another order by PyTorch and XLA, carried over the run).

Within the port: batch equals delta bitwise at a matched prox cadence,
`run` composes bitwise, and the SGD engines track the float64 minibatch
simulator within the reference's own envelope
(tests/test_engine_vs_simulator.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import amtl as jamtl  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.data import stack_ragged as jstack  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import amtl, prng  # noqa: E402
from repro_torch.core.operators import amtl_max_step  # noqa: E402
from repro_torch.core.simulator import (NetworkModel, make_synthetic,  # noqa: E402
                                        simulate_amtl)
from repro_torch.interop import LEAVES, state_to_numpy  # noqa: E402

ENGINE_RTOL = 1e-4
HOST_FIELDS = ("task_ring", "ptr", "event", "history.buf", "history.count",
               "key")
SIZES = (12, 30, 21, 4, 30)
D = 10


def _cohorts(loss="lstsq", seed=0, sizes=SIZES):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal((n, D)) / np.sqrt(D)).astype(np.float32)
          for n in sizes]
    ys = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    if loss == "logistic":
        ys = [np.where(y > 0, 1.0, -1.0).astype(np.float32) for y in ys]
    return xs, ys


@pytest.fixture(scope="module", params=["lstsq", "logistic"])
def problems(request):
    xs, ys = _cohorts(request.param)
    return (jstack(xs, ys, request.param, "nuclear", 0.1),
            rt.stack_ragged(xs, ys, request.param, "nuclear", 0.1,
                            device="cpu"))


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


OFFSETS = np.array([3.0, 1.0, 0.0, 2.0, 4.0], np.float32)
CASES = [
    dict(engine="delta", batch_size=8),
    dict(engine="delta", batch_size=1, prox_every=4, prox_rank=2,
         dynamic_step=True),
    dict(engine="batch", event_batch=4, prox_every=4, batch_size=8),
    dict(engine="batch", event_batch=4, prox_every=8, prox_rank=2,
         batch_size=3, tau=4),
    dict(engine="batch", event_batch=2, prox_every=2, batch_size=64),
]


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_sgd_engine_matches_jax(problems, case):
    jp, tp = problems
    jcfg, tcfg = _cfgs(jp, **case)
    key = jax.random.PRNGKey(21)
    v0 = np.full((D, len(SIZES)), 0.01, np.float32)
    je = jamtl.make_engine(jp, jcfg)
    te = rt.make_engine(tp, tcfg, device="cpu")
    n = 64
    js = je.run(je.init(jnp.asarray(v0), key), jnp.asarray(OFFSETS), n)
    ts = te.run(te.init(v0, np.asarray(key)), OFFSETS, n)
    _assert_states_match(js, ts)
    _assert_states_match(je.run(js, jnp.asarray(OFFSETS), n),
                         te.run(ts, OFFSETS, n))


@pytest.mark.parametrize("engine", ["delta", "batch"])
def test_event_stream_and_minibatch_seeds_bitwise_vs_jax(problems, engine):
    """The plan's tasks and per-event seeds are the JAX chain's, event by
    event, and its scalar blocks are the JAX kernel's `_scalars`."""
    from repro.kernels.lstsq_grad_sampled import _scalars
    jp, tp = problems
    extra = dict(event_batch=4, prox_every=4) if engine == "batch" else {}
    jcfg, tcfg = _cfgs(jp, engine=engine, batch_size=5, **extra)
    key = jax.random.PRNGKey(5)
    te = rt.make_engine(tp, tcfg, device="cpu")
    state = te.init(np.zeros((D, len(SIZES)), np.float32), np.asarray(key))
    n = 96
    plan = amtl.plan_events(tp, tcfg, state, OFFSETS, n)
    counts = np.asarray(SIZES)
    k = key
    for e in range(n):
        seed = jamtl._minibatch_seed(k)
        k, t, _ = jamtl._sample_activation(jcfg, jnp.asarray(OFFSETS), k,
                                           len(SIZES), e)
        assert int(t) == plan.tasks[e], e
        np.testing.assert_array_equal(
            plan.scalars[e],
            np.asarray(_scalars(tp.xs.shape[1], 5, seed,
                                jnp.int32(counts[int(t)]))).reshape(4))
    np.testing.assert_array_equal(plan.key, np.asarray(k))


@pytest.mark.parametrize("tau,bsz,k,extra", [
    (3, 4, 1, dict(batch_size=5)),
    (4, 5, 2, dict(batch_size=1, dynamic_step=True, prox_rank=2)),
    (3, 2, 3, dict(batch_size=40, delay_jitter=2.0)),
])
def test_sgd_batch_equals_delta_bitwise(problems, tau, bsz, k, extra):
    jp, tp = problems
    _, delta = _cfgs(jp, tau=tau, engine="delta", prox_every=k * bsz,
                     **extra)
    batch = delta._replace(engine="batch", event_batch=bsz)
    v0 = np.zeros((D, len(SIZES)), np.float32)
    key = prng.key_from_seed(3)
    n = 4 * k * bsz
    d = rt.amtl_events_only(tp, delta, v0, key, n, OFFSETS, device="cpu")
    b = rt.amtl_events_only(tp, batch, v0, key, n, OFFSETS, device="cpu")
    for a, c, name in zip(state_to_numpy(d), state_to_numpy(b), LEAVES):
        if name == "p_cache" and k == 1:
            continue              # delta carries a cache; aligned batch not
        np.testing.assert_array_equal(a, c, err_msg=name)


@pytest.mark.parametrize("case", [
    dict(engine="delta", prox_every=3, prox_rank=2, batch_size=4),
    dict(engine="batch", event_batch=4, prox_every=8, batch_size=2),
])
def test_sgd_run_composes_bitwise(problems, case):
    jp, tp = problems
    _, cfg = _cfgs(jp, **case)
    eng = rt.make_engine(tp, cfg, device="cpu")
    s0 = eng.init(np.zeros((D, len(SIZES)), np.float32),
                  prng.key_from_seed(4))
    s8 = eng.run(s0, None, 8)
    whole = eng.run(s0, None, 24)
    split = eng.run(s8, None, 16)
    for a, c, name in zip(state_to_numpy(whole), state_to_numpy(split),
                          LEAVES):
        np.testing.assert_array_equal(a, c, err_msg=name)


# ------------------------------------------- float64 minibatch simulator
# tests/test_engine_vs_simulator.py's SGD section, on the port: the same
# problem, config and envelope (the selection laws differ, so agreement
# is trajectory-level).

T, SIM_D, SIM_N, TAU, EPOCHS, BSZ = 4, 12, 30, 4, 400, 10


@pytest.fixture(scope="module")
def sim_problem():
    return make_synthetic(num_tasks=T, samples=SIM_N, dim=SIM_D, seed=0)


@pytest.fixture(scope="module")
def stacked(sim_problem):
    return rt.problem_from_numpy(np.stack(sim_problem.xs),
                                 np.stack(sim_problem.ys), "lstsq",
                                 "nuclear", 0.1, device="cpu")


@pytest.fixture(scope="module")
def sgd_reference(sim_problem, stacked):
    sim = simulate_amtl(sim_problem,
                        NetworkModel(delay_offset=0.0, delay_jitter=1.0),
                        num_epochs=EPOCHS, eta=float(1.0 / stacked.lipschitz()),
                        eta_k=float(amtl_max_step(TAU, T)), tau=TAU, seed=0,
                        batch_size=BSZ)
    return sim, np.asarray(sim.objectives)[T - 1::T]


@pytest.fixture(scope="module")
def sgd_runs(stacked):
    cfg = rt.AMTLConfig(eta=1.0 / stacked.lipschitz(),
                        eta_k=amtl_max_step(TAU, T), tau=TAU,
                        batch_size=BSZ)
    w0 = np.zeros((SIM_D, T), np.float32)
    key = prng.key_from_seed(0)
    return {engine: rt.amtl_solve(
        stacked, cfg._replace(engine=engine), w0, key, num_epochs=EPOCHS,
        device="cpu") for engine in ("delta", "batch")}


def test_port_simulator_is_the_reference_simulator(sim_problem):
    """The port's copy of the float64 simulator gives the reference's
    numbers bit for bit."""
    net = NetworkModel(delay_offset=1.0, delay_jitter=1.0)
    ref_prob = jsim.make_synthetic(num_tasks=T, samples=SIM_N, dim=SIM_D,
                                   seed=0)
    for bs in (None, 7):
        a = simulate_amtl(sim_problem, net, num_epochs=20, tau=TAU,
                          batch_size=bs, prox_every=2)
        b = jsim.simulate_amtl(ref_prob, jsim.NetworkModel(1.0, 1.0),
                               num_epochs=20, tau=TAU, batch_size=bs,
                               prox_every=2)
        np.testing.assert_array_equal(a.w, b.w)
        assert a.objectives == b.objectives and a.total_time == b.total_time


def test_sgd_engines_agree_bitwise_with_each_other(sgd_runs):
    np.testing.assert_array_equal(sgd_runs["delta"].v.numpy(),
                                  sgd_runs["batch"].v.numpy())
    np.testing.assert_array_equal(sgd_runs["delta"].objectives.numpy(),
                                  sgd_runs["batch"].objectives.numpy())


@pytest.mark.parametrize("engine", ["delta", "batch"])
def test_sgd_trajectory_tracks_float64_minibatch_reference(
        engine, sgd_runs, sgd_reference):
    _, sim_traj = sgd_reference
    objs = sgd_runs[engine].objectives.numpy().astype(np.float64)
    rel = np.abs(objs - sim_traj) / sim_traj
    assert rel.max() < 0.6, rel.max()
    assert rel[100:].max() < 0.08, rel[100:].max()
    assert rel[-1] < 0.02, rel[-1]
    assert objs[-1] < objs[100] < objs[0]


@pytest.mark.parametrize("engine", ["delta", "batch"])
def test_sgd_final_iterate_matches_float64_minibatch_reference(
        engine, sgd_runs, sgd_reference):
    sim, _ = sgd_reference
    w = sgd_runs[engine].w.numpy().astype(np.float64)
    rel = np.linalg.norm(w - sim.w) / np.linalg.norm(sim.w)
    assert rel < 0.05, rel


def test_sgd_batch_size_above_n_is_bitwise_full(stacked):
    """batch_size > n saturates every event: the run is the full-gradient
    engine's, bitwise."""
    full = rt.AMTLConfig(eta=1.0 / stacked.lipschitz(),
                         eta_k=amtl_max_step(TAU, T), tau=TAU)
    w0 = np.zeros((SIM_D, T), np.float32)
    key = prng.key_from_seed(0)
    a = rt.amtl_solve(stacked, full, w0, key, num_epochs=50, device="cpu")
    b = rt.amtl_solve(stacked, full._replace(batch_size=SIM_N + 69), w0, key,
                      num_epochs=50, device="cpu")
    assert torch.equal(a.v, b.v) and torch.equal(a.objectives, b.objectives)
