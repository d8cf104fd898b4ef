"""The port's task-sharded engine across real rank boundaries: 2- and
4-rank torch.distributed worlds (gloo on the CPU, `file://` rendezvous,
`launch.mesh.run_world`), the contracts of
tests/test_amtl_sharded_multidevice.py at its sizes (T 8, d 6, n 12).

One spawn a world size runs every configuration (`launch.amtl_sharded.
session`, the rank function of the port; the ranks import no JAX), and
each test reads its configuration's gathered global state:

  * replicated prox: the event stream and v bitwise the port's batch
    engine (uniform, straggler, SGD, ragged, the decoupled cadence), and
    within ENGINE_RTOL of JAX's batch engine (float32 products summed in
    another order; tests/test_torch_engine.py);
  * distributed prox: the stream bitwise, v within rtol 5e-4, atol 1e-5
    of the port's batch engine and of JAX's (the (d, p) sum regroups the
    sketch's sum over T; the reference's own tolerance);
  * amtl_solve at 2 ranks: v bitwise, W, objectives and residuals within
    the reference's tolerances (the metrics' sums are regrouped);
  * a save at 2 ranks restores at 2 ranks and resumes bitwise;
  * 3 ranks on T 8 raise the divisibility ValueError in the ranks, and a
    world that outlives its timeout raises in the parent.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import MTLProblem as JProblem  # noqa: E402
from repro.core import amtl as jamtl  # noqa: E402
from repro.core import make_synthetic  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.interop import LEAVES, state_to_numpy  # noqa: E402
from repro_torch.launch import amtl_sharded  # noqa: E402
from repro_torch.launch.mesh import run_world  # noqa: E402

ENGINE_RTOL = 1e-4
DIST_RTOL, DIST_ATOL = 5e-4, 1e-5
EVENTS = 40
WORLD_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 300.0, 60.0
STRAGGLE = np.array([3.0, 3.0, 3.0, 3.0, 0.0, 0.0, 0.0, 0.0], np.float32)
KEY = np.asarray(jax.random.PRNGKey(2))
STREAM_FIELDS = ("task_ring", "ptr", "event", "history.buf",
                 "history.count", "key")


def _data():
    prob = make_synthetic(num_tasks=8, samples=12, dim=6, seed=1)
    xs = np.stack(prob.xs).astype(np.float32)
    ys = np.stack(prob.ys).astype(np.float32)
    counts = np.random.default_rng(4).integers(3, 13, 8).astype(np.int32)
    return xs, ys, counts


def _base(xs, ys):
    eta = 1.0 / rt.problem_from_numpy(xs, ys, "lstsq", "nuclear", 0.1,
                                      device="cpu").lipschitz()
    return dict(eta=eta, eta_k=0.6, tau=3, engine="sharded", prox_every=4,
                event_batch=4)


def _cases(xs, ys):
    base = _base(xs, ys)
    sketch = dict(base, dynamic_step=True, prox_rank=4)
    dist = dict(sketch, prox_mode="distributed")
    return {
        "uniform": dict(cfg=base),
        "straggler": dict(cfg=sketch, offsets=STRAGGLE),
        "sgd": dict(cfg=dict(base, batch_size=3)),
        "sgd-straggler": dict(cfg=dict(sketch, batch_size=3),
                              offsets=STRAGGLE),
        "ragged": dict(cfg=dict(base, batch_size=3), problem="ragged"),
        "ragged-full": dict(cfg=base, problem="ragged"),
        "decoupled": dict(cfg=dict(sketch, prox_every=8), offsets=STRAGGLE),
        "dist-straggler": dict(cfg=dist, offsets=STRAGGLE),
        "dist-decoupled": dict(cfg=dict(dist, prox_every=8),
                               offsets=STRAGGLE),
    }


def _spec(xs, ys, counts, ckpt_dir):
    problems = {
        "uniform": dict(xs=xs, ys=ys, row_counts=None, loss="lstsq",
                        reg="nuclear", lam=0.1),
        "ragged": dict(xs=xs, ys=ys, row_counts=counts, loss="lstsq",
                       reg="nuclear", lam=0.1)}
    runs = [dict(dict(problem="uniform", key=KEY, events=EVENTS), **case)
            for case in _cases(xs, ys).values()]
    base = _base(xs, ys)
    runs.append(dict(problem="uniform", key=KEY, cfg=base, solve=6))
    runs.append(dict(problem="uniform", key=KEY, cfg=base, events=EVENTS,
                     save=(ckpt_dir, EVENTS // 2)))
    runs.append(dict(problem="uniform", key=KEY, cfg=base, events=EVENTS,
                     restore=(ckpt_dir, EVENTS // 2)))
    return dict(device="cpu", problems=problems, runs=runs)


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module", params=[2, 4])
def world(request, data, tmp_path_factory):
    """(ranks, every rank's results) of one spawned world."""
    xs, ys, counts = data
    ckpt = str(tmp_path_factory.mktemp(f"ckpt{request.param}"))
    out = run_world(amtl_sharded.session, request.param,
                    _spec(xs, ys, counts, ckpt), device="cpu",
                    timeout=WORLD_TIMEOUT_S,
                    collective_timeout=COLLECTIVE_TIMEOUT_S, verbose=False)
    return request.param, out


def _problem(data, case):
    xs, ys, counts = data
    ragged = case.get("problem") == "ragged"
    return rt.problem_from_numpy(xs, ys, "lstsq", "nuclear", 0.1,
                                 device="cpu",
                                 row_counts=counts if ragged else None)


def _batch(data, case):
    """The port's batch engine on the case (replicated prox)."""
    cfg = rt.AMTLConfig(**case["cfg"])._replace(engine="batch",
                                                prox_mode="replicated")
    w0 = np.zeros((6, 8), np.float32)
    return rt.amtl_events_only(_problem(data, case), cfg, w0, KEY, EVENTS,
                               delay_offsets=case.get("offsets"),
                               device="cpu")


def _jax_batch(data, case):
    xs, ys, counts = data
    ragged = case.get("problem") == "ragged"
    jp = JProblem(jnp.asarray(xs), jnp.asarray(ys), "lstsq", "nuclear", 0.1,
                  jnp.asarray(counts) if ragged else None)
    cfg = jamtl.AMTLConfig(**case["cfg"])._replace(engine="batch",
                                                   prox_mode="replicated")
    offs = case.get("offsets")
    return jamtl.amtl_events_only(
        jp, cfg, jnp.zeros((6, 8), jnp.float32), jnp.asarray(KEY), EVENTS,
        delay_offsets=None if offs is None else jnp.asarray(offs))


def _results(world, index):
    ranks, out = world
    mine = out[0][index]
    for r in range(1, ranks):
        for name, a, b in zip(LEAVES, mine["leaves"],
                              out[r][index]["leaves"]):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {name}")
    return dict(zip(LEAVES, mine["leaves"]))


def _assert_stream(got, want_state):
    want = dict(zip(LEAVES, state_to_numpy(want_state)))
    for f in STREAM_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _assert_owned_ring(got, batch_state, ranks):
    """Each slot of the batch ring equals the slot of its task's owner."""
    want = batch_state.delta_ring.numpy()
    owner = batch_state.task_ring // (8 // ranks)
    assert got["delta_ring"].shape == (ranks, 4, 6)
    for j in range(want.shape[0]):
        np.testing.assert_array_equal(got["delta_ring"][owner[j], j],
                                      want[j])


CASE_NAMES = list(_cases(*_data()[:2]))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_world_matches_batch_engine(world, data, name):
    """Replicated prox: stream, v and the owned ring slots bitwise the
    port's batch engine, v within ENGINE_RTOL of JAX's.  Distributed
    prox: v within DIST_RTOL/DIST_ATOL of the port's batch engine and of
    JAX's.  The stream bitwise both engines' either way."""
    ranks, _ = world
    case = _cases(data[0], data[1])[name]
    got = _results(world, CASE_NAMES.index(name))
    b = _batch(data, case)
    _assert_stream(got, b)
    theirs = dict(zip(LEAVES, (np.asarray(a) for a in jax.tree_util.
                               tree_leaves(_jax_batch(data, case)))))
    for f in STREAM_FIELDS:
        np.testing.assert_array_equal(got[f], theirs[f], err_msg=f)
    want = theirs["v"].astype(np.float64)
    if case["cfg"].get("prox_mode") == "distributed":
        np.testing.assert_allclose(got["v"], b.v.numpy(), rtol=DIST_RTOL,
                                   atol=DIST_ATOL)
        np.testing.assert_allclose(got["v"], want, rtol=DIST_RTOL,
                                   atol=DIST_ATOL)
        return
    np.testing.assert_array_equal(got["v"], b.v.numpy())
    _assert_owned_ring(got, b, ranks)
    if case["cfg"]["prox_every"] > case["cfg"]["event_batch"]:
        np.testing.assert_array_equal(got["p_cache"], b.p_cache.numpy())
    assert np.abs(got["v"] - want).max() <= ENGINE_RTOL * np.abs(want).max()


def test_world_straggler_regime(world, data):
    """The lagging shard's tasks read stale, the others fresh, and both
    halves are activated, at every shard count."""
    got = _results(world, CASE_NAMES.index("straggler"))
    buf, count = got["history.buf"], got["history.count"]
    mean = buf.sum(axis=1) / np.maximum(np.minimum(count, 5), 1)
    assert mean[:4].min() >= 2.0 and mean[4:].max() <= 1.0, mean
    assert count[:4].sum() > 0 and count[4:].sum() > 0
    sgd = _results(world, CASE_NAMES.index("sgd"))
    full = _results(world, CASE_NAMES.index("uniform"))
    np.testing.assert_array_equal(sgd["task_ring"], full["task_ring"])
    np.testing.assert_array_equal(sgd["key"], full["key"])
    assert not np.array_equal(sgd["v"], full["v"])


def test_world_amtl_solve_matches_batch(world, data):
    """amtl_solve: v bitwise, W and the per-epoch metrics within the
    reference's tolerances (rtol 1e-6/1e-5/1e-4): the metrics' sums over
    the tasks are regrouped by rank."""
    _, out = world
    res = out[0][len(CASE_NAMES)]
    xs, ys, _ = data
    cfg = rt.AMTLConfig(**_base(xs, ys))._replace(engine="batch")
    want = rt.amtl_solve(_problem(data, {}), cfg, np.zeros((6, 8),
                                                           np.float32),
                         KEY, num_epochs=6, device="cpu")
    np.testing.assert_array_equal(res["v"], want.v.numpy())
    np.testing.assert_allclose(res["w"], want.w.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(res["objectives"], want.objectives.numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(res["residuals"], want.residuals.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_world_checkpoint_resumes_bitwise(world):
    """A record saved by every rank at event 20 (rank 0 writes the global
    view) restores at the same rank count and resumes bitwise; the run
    that saved equals the uninterrupted one."""
    _, out = world
    saved = out[0][len(CASE_NAMES) + 1]["leaves"]
    resumed = out[0][len(CASE_NAMES) + 2]["leaves"]
    uninterrupted = out[0][CASE_NAMES.index("uniform")]["leaves"]
    for name, a, b, c in zip(LEAVES, saved, resumed, uninterrupted):
        np.testing.assert_array_equal(a, c, err_msg=name)
        np.testing.assert_array_equal(b, c, err_msg=name)


def test_three_ranks_on_eight_tasks_raise(data):
    xs, ys, counts = data
    spec = _spec(xs, ys, counts, "unused")
    spec["runs"] = spec["runs"][:1]
    with pytest.raises(RuntimeError, match="divisible"):
        run_world(amtl_sharded.session, 3, spec, device="cpu",
                  timeout=WORLD_TIMEOUT_S,
                  collective_timeout=COLLECTIVE_TIMEOUT_S, verbose=False)


def test_world_that_hangs_raises_within_its_timeout():
    """Ranks that never finish are stopped and the parent raises."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        run_world(time.sleep, 2, 120, device="cpu", timeout=5.0,
                  verbose=False)
    assert time.monotonic() - t0 < 60
