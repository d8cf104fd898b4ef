"""The learn-while-serve `AMTLServer` on a lockstep world of 2 and 4 ranks
(gloo on the CPU, `launch.mesh.run_world`, one spawn a world size), at
the reference test sizes (T 8, d 6), driven by `launch.serve_lockstep`
(the rank function of the port) with the test-only ops of
`torch_lockstep_ops` (the ranks import no JAX):

  * the cooperative script (labelled and label-free feedback, predicts,
    steps) is bitwise the port's one-rank server (receipts, predictions,
    snapshots, chunk log, state, each rank's store block, the whole
    store's counts), and within SERVE_RTOL of JAX's one-rank server
    driven by the same script;
  * between calls a rank holds only its T / n tasks: its problem block,
    its engine's and its store shard;
  * a save at 2 ranks resumes at 1, 2 and 4 ranks bitwise the
    uninterrupted run, and in JAX's server on a 2-device mesh (a
    subprocess) within SERVE_RTOL; a one-rank save resumes at 4 ranks
    bitwise, and a JAX one-rank record at 2 ranks bitwise the port's
    one-rank resume of it;
  * the threaded learner, 10 times in one world, drains bitwise the
    cooperative loop, every collective of a rank from its learner
    thread; a crash on rank 1 alone heals with nothing lost; a breaker
    tripped on rank 1 latches every rank frozen; with feedback over the
    per-task cap submitted while the learner runs, every rank's store
    holds exactly the rows rank 0's receipts accepted (another rank's
    receipts are advisory);
  * the distributed prox: chunks, receipts and event stream bitwise, the
    iterate within DIST_RTOL;
  * a rank killed by SIGKILL mid-chunk: the world raises within its
    collective timeout, naming the signal and the other rank's error.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import AMTLConfig as JConfig  # noqa: E402
from repro.core import MTLProblem as JProblem  # noqa: E402
from repro.core import make_synthetic  # noqa: E402
from repro.serve import AMTLServer as JServer  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.launch.mesh import exit_reason, run_world  # noqa: E402
from torch_lockstep_ops import session  # noqa: E402

T, D, N = 8, 6, 12
SERVE_RTOL = 1e-4
DIST_RTOL, DIST_ATOL = 5e-4, 1e-5
THREADED_REPS = 10
WORLD_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 120.0, 30.0
KEY = np.asarray(jax.random.PRNGKey(4))
SRC = Path(__file__).resolve().parents[1] / "src"


def _data():
    prob = make_synthetic(num_tasks=T, samples=N, dim=D, seed=1)
    return (np.stack(prob.xs).astype(np.float32),
            np.stack(prob.ys).astype(np.float32))


def _cfg(xs, ys, **kw):
    lip = float(JProblem(jnp.asarray(xs), jnp.asarray(ys), "lstsq",
                         "nuclear", 0.1).lipschitz())
    return dict(dict(eta=1.0 / lip, eta_k=0.7, tau=3, engine="sharded",
                     event_batch=2, prox_every=2), **kw)


SERVE = dict(chunk_events=4, task_chunk_quota=2, max_pending_per_task=3)
# the save and resume runs: no admission caps and an even number of
# feedback items a round, so that the queue is empty at the save (a
# resume loses what was pending, in the reference too)
SERVE_SAVE = dict(chunk_events=4)


def _rounds(seed: int, lo: int, hi: int, even: bool = False) -> list:
    """Rounds lo..hi-1 of a script: feedback (labelled, or label-free
    every third), a predict, a step."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(hi):
        k = int(rng.integers(3, 9))
        k -= k % 2 if even else 0
        t = rng.integers(0, T, size=k)
        if i % 3 == 1:
            fb = ("feedback", np.zeros(k, np.int64))
        else:
            x = (rng.standard_normal((k, D)) / np.sqrt(D)).astype(np.float32)
            fb = ("feedback", t, x, rng.standard_normal(k).astype(np.float32))
        q = ("predict", rng.integers(0, T, size=5),
             rng.standard_normal((5, D)).astype(np.float32))
        if i >= lo:
            ops += [fb, q, ("step",)]
    return ops


SCRIPT = _rounds(7, 0, 4) + [("drain",)] + _rounds(7, 4, 8)
FIRST = _rounds(8, 0, 4, even=True) + [("drain",)]
SECOND = _rounds(8, 4, 8, even=True)


def _threaded_ops():
    rng = np.random.default_rng(3)
    ops = [("feedback", rng.integers(0, T, 6)) for _ in range(3)]
    x = rng.standard_normal((5, D)).astype(np.float32)
    ops.append(("feedback", np.arange(5) % T, x,
                rng.standard_normal(5).astype(np.float32)))
    return ops


def _capped_ops():
    """Labelled feedback of one task an op, 3 rows over a cap of 2 (a
    call's accepted rows are its first, so rank 0's receipt says which
    rows the world folds)."""
    rng = np.random.default_rng(9)
    ops = []
    for _ in range(12):
        x = (rng.standard_normal((3, D)) / np.sqrt(D)).astype(np.float32)
        ops.append(("feedback", np.full(3, rng.integers(0, T)), x,
                    rng.standard_normal(3).astype(np.float32)))
    return ops


CAPPED = _capped_ops()


def _spec(xs, ys, servers):
    return dict(device="cpu", problem=dict(xs=xs, ys=ys, loss="lstsq",
                                           reg="nuclear", lam=0.1),
                v0=np.zeros((D, T), np.float32), key=KEY, servers=servers)


# ------------------------------------------------------------- fixtures --
@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("lockstep")
    return {k: str(root / k) for k in ("port2", "jax1", "port1")}


@pytest.fixture(scope="module")
def jax_one(data, ckpts):
    """JAX's one-rank server (batch engine) through the script, its record
    saved after FIRST: (results, record dir)."""
    xs, ys = data
    cfg = _cfg(xs, ys, engine="batch")
    server = JServer(JProblem(jnp.asarray(xs), jnp.asarray(ys), "lstsq",
                              "nuclear", 0.1), JConfig(**cfg),
                     jnp.zeros((D, T)), jnp.asarray(KEY),
                     JServeConfig(**SERVE, ckpt_dir=ckpts["jax1"]))
    out = {"receipts": [], "preds": [], "ran": []}
    for op in SCRIPT:
        _jax_op(server, op, out)
        if op[0] == "drain":
            server.checkpoint()
    out["chunk_log"] = list(server.chunk_log)
    out["v"] = np.asarray(server.iterate())
    out["store"] = [np.asarray(a) for a in server._store.state()]
    return out


def _jax_op(server, op, out):
    if op[0] == "feedback":
        r = server.submit_feedback(*op[1:])
        out["receipts"].append((tuple(r), r.reason))
    elif op[0] == "predict":
        out["preds"].append(np.asarray(server.predict(*op[1:])))
    elif op[0] == "step":
        out["ran"].append(server.step())
    elif op[0] == "drain":
        while server.step():
            pass


@pytest.fixture(scope="module")
def one(data, ckpts, jax_one):
    """The port's one-rank servers (batch engine): the script, the save
    script (saved after FIRST), a resume from JAX's record, the
    cooperative drain of the threaded feedback, and the script with the
    randomized prox."""
    xs, ys = data
    batch = _cfg(xs, ys, engine="batch")
    jax_second = SCRIPT[SCRIPT.index(("drain",)) + 1:]
    servers = [
        dict(cfg=batch, serve=SERVE, ops=SCRIPT),
        dict(cfg=batch, serve=dict(SERVE_SAVE, ckpt_dir=ckpts["port1"]),
             ops=FIRST + [("checkpoint",)] + SECOND),
        dict(cfg=batch, serve=dict(SERVE, ckpt_dir=ckpts["jax1"]),
             resume=True, ops=jax_second),
        dict(cfg=batch, serve=SERVE, ops=_threaded_ops() + [("drain",)]),
        dict(cfg=_cfg(xs, ys, engine="batch", prox_rank=4), serve=SERVE,
             ops=SCRIPT)]
    return session(_spec(xs, ys, servers))


def _world_servers(xs, ys, ckpts, n):
    """At 4 ranks: 0 the script, 1 a resume from the 2-rank save, 2 one
    from the one-rank save.  At 2
    ranks: 0 the script, 1 the save script with its save, 2 a resume from
    it, 3 a resume from JAX's record, then the threaded runs, the crash,
    the breaker and the distributed prox."""
    cfg = _cfg(xs, ys)
    saved = dict(SERVE_SAVE, ckpt_dir=ckpts["port2"])
    servers = [dict(cfg=cfg, serve=SERVE, ops=SCRIPT)]
    if n == 4:
        return servers + [
            dict(cfg=cfg, serve=saved, resume=True, ops=SECOND),
            dict(cfg=cfg, serve=dict(SERVE_SAVE, ckpt_dir=ckpts["port1"]),
                 resume=True, ops=SECOND)]
    servers = [servers[0],
               dict(cfg=cfg, serve=saved,
                    ops=FIRST + [("checkpoint",)] + SECOND),
               dict(cfg=cfg, serve=saved, resume=True, ops=SECOND),
               dict(cfg=cfg, serve=dict(SERVE, ckpt_dir=ckpts["jax1"]),
                    resume=True,
                    ops=SCRIPT[SCRIPT.index(("drain",)) + 1:])]
    threaded = _threaded_ops() + [
        ("start",), ("predict_rows_while", 20, np.arange(5) % T,
                     np.ones((5, D), np.float32)), ("stop", True)]
    servers += [dict(cfg=cfg, serve=SERVE, ops=threaded)] * THREADED_REPS
    servers.append(dict(cfg=cfg, serve=dict(SERVE, restart_limit=2,
                                            restart_backoff_s=0.01),
                        faults={1: dict(crash_on_chunks={1})}, ops=threaded))
    rng = np.random.default_rng(5)
    servers.append(dict(
        cfg=cfg, serve=dict(SERVE, max_pending_per_task=None,
                            restart_limit=1, restart_backoff_s=0.01),
        faults={1: dict(crash_on_chunks=set(range(64)))},
        ops=[("feedback", rng.integers(0, T, 6)) for _ in range(6)] + [
            ("start",), ("wait", "breaker"),
            ("predict", np.arange(3), np.ones((3, D), np.float32)),
            ("feedback", np.array([0, 1])), ("step",), ("stop", False)]))
    servers.append(dict(cfg=_cfg(xs, ys, prox_rank=4,
                                 prox_mode="distributed"),
                        serve=SERVE, ops=SCRIPT))
    servers.append(dict(cfg=cfg, serve=dict(SERVE, max_pending_per_task=2),
                        ops=[("start",)] + CAPPED + [("stop", True)]))
    return servers


@pytest.fixture(scope="module")
def world2(data, ckpts, jax_one):
    xs, ys = data
    return run_world(session, 2,
                     _spec(xs, ys, _world_servers(xs, ys, ckpts, 2)),
                     device="cpu", timeout=WORLD_TIMEOUT_S,
                     collective_timeout=COLLECTIVE_TIMEOUT_S, verbose=False)


_JAX_RESUME = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
import jax, jax.numpy as jnp
from repro.core import AMTLConfig, MTLProblem
from repro.launch.mesh import make_task_mesh
from repro.serve import AMTLServer, ServeConfig
spec = pickle.load(open(sys.argv[1], "rb"))
problem = MTLProblem(jnp.asarray(spec["xs"]), jnp.asarray(spec["ys"]),
                     "lstsq", "nuclear", 0.1)
server = AMTLServer.resume(problem, AMTLConfig(**spec["cfg"]),
                           jnp.zeros(spec["v0_shape"]),
                           jnp.asarray(spec["key"]),
                           ServeConfig(**spec["serve"]),
                           mesh=make_task_mesh(2))
out = {"start": server.event_count, "receipts": [], "preds": []}
for op in spec["ops"]:
    if op[0] == "feedback":
        r = server.submit_feedback(*op[1:])
        out["receipts"].append((tuple(r), r.reason))
    elif op[0] == "predict":
        out["preds"].append(np.asarray(server.predict(*op[1:])))
    elif op[0] == "step":
        server.step()
out["chunk_log"] = list(server.chunk_log)
out["v"] = np.asarray(server.iterate())
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def jax_resume(data, ckpts, world2, tmp_path_factory):
    """JAX's server on a 2-device mesh (a subprocess) resumed from the
    2-rank port record, through SECOND; started here, read at the end."""
    xs, ys = data
    tmp = tmp_path_factory.mktemp("jax_resume")
    spec_path, out_path = tmp / "spec.pkl", tmp / "out.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(dict(xs=xs, ys=ys, cfg=_cfg(xs, ys), v0_shape=(D, T),
                         key=KEY,
                         serve=dict(SERVE_SAVE, ckpt_dir=ckpts["port2"]),
                         ops=SECOND), f)
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", _JAX_RESUME,
                             str(spec_path), str(out_path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def result():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        with open(out_path, "rb") as f:
            return pickle.load(f)
    return result


@pytest.fixture(scope="module")
def world4(data, ckpts, world2, jax_resume, one):
    xs, ys = data
    return run_world(session, 4,
                     _spec(xs, ys, _world_servers(xs, ys, ckpts, 4)),
                     device="cpu", timeout=WORLD_TIMEOUT_S,
                     collective_timeout=COLLECTIVE_TIMEOUT_S, verbose=False)


@pytest.fixture(scope="module")
def one_from_port2(data, ckpts, world2):
    """The port's one-rank server resumed from the 2-rank record."""
    xs, ys = data
    return session(_spec(xs, ys, [dict(
        cfg=_cfg(xs, ys, engine="batch"),
        serve=dict(SERVE_SAVE, ckpt_dir=ckpts["port2"]), resume=True,
        ops=SECOND)]))[0]


# ---------------------------------------------------------------- checks --
def _bitwise(a, b, keys=("receipts", "chunk_log", "ran")):
    for k in keys:
        assert a[k] == b[k], k
    assert len(a["preds"]) == len(b["preds"])
    for x, y in zip(a["preds"], b["preds"]):
        np.testing.assert_array_equal(x, y)
    assert [e for e, _ in a["snapshots"]] == [e for e, _ in b["snapshots"]]
    for (_, x), (_, y) in zip(a["snapshots"], b["snapshots"]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a["state"], b["state"], strict=True):
        np.testing.assert_array_equal(x, y)


def _served(res) -> list:
    """The snapshot each predict of SCRIPT was served from (v0 first)."""
    cur, i, out = np.zeros((D, T), np.float32), 0, []
    for op in SCRIPT:
        if op[0] == "predict":
            out.append(cur)
        elif op[0] in ("step", "drain"):
            while True:
                cur, ran = res["snapshots"][i][1], res["ran"][i]
                i += 1
                if op[0] == "step" or not ran:
                    break
    return out


def _assert_store(res, ref, rank, n):
    lo, hi = rank * T // n, (rank + 1) * T // n
    xs, ys, counts = res["store"]
    rx, ry, rc = ref["store"]
    np.testing.assert_array_equal(xs, rx[lo:hi])
    np.testing.assert_array_equal(ys, ry[lo:hi])
    np.testing.assert_array_equal(counts, rc[lo:hi])
    assert res["counts"] == ref["counts"]


@pytest.mark.parametrize("n", [2, 4])
def test_cooperative_script_is_bitwise_the_one_rank_server(n, world2,
                                                           world4, one):
    world = world2 if n == 2 else world4
    for rank, res in enumerate(world):
        _bitwise(res[0], one[0])
        _assert_store(res[0], one[0], rank, n)
        assert res[0]["stats"]["store_rows"] == one[0]["stats"]["store_rows"]
        assert res[0]["wire"]["boundaries"] == len(one[0]["ran"])


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_holds_only_its_tasks(n, world2, world4):
    world = world2 if n == 2 else world4
    cap = world[0][0]["block"][0][1]
    for res in world:
        problem, engine, store = res[0]["block"]
        assert problem == (T // n, cap, D) and engine == problem
        assert store == T // n
        assert res[0]["store"][0].shape == (T // n, cap, D)


def test_cooperative_script_within_tolerance_of_jax(world2, jax_one):
    res = world2[0][0]
    assert res["chunk_log"] == jax_one["chunk_log"]
    assert res["receipts"] == jax_one["receipts"]
    v = jax_one["v"]
    got = res["snapshots"][-1][1]
    assert np.abs(got - v).max() <= SERVE_RTOL * np.abs(v).max()
    predicts = [op for op in SCRIPT if op[0] == "predict"]
    for (_, q, x), cur, a, b in zip(predicts, _served(res), res["preds"],
                                    jax_one["preds"], strict=True):
        scale = np.linalg.norm(x, axis=1) * np.linalg.norm(cur[:, q], axis=0)
        assert (np.abs(a - b) <= SERVE_RTOL * scale + 1e-30).all()
    for a, b in zip(res["store"], jax_one["store"]):
        np.testing.assert_array_equal(a, b[:T // 2])


@pytest.mark.parametrize("saved, ranks", [(2, 1), (2, 2), (2, 4), (1, 4)])
def test_save_resumes_bitwise_at_other_rank_counts(saved, ranks, world2,
                                                   world4, one,
                                                   one_from_port2):
    k = sum(1 for op in SECOND if op[0] == "step")
    runs = {(2, 1): [one_from_port2], (2, 2): [r[2] for r in world2],
            (2, 4): [r[1] for r in world4],
            (1, 4): [r[2] for r in world4]}[saved, ranks]
    want = one[1]
    for res in world2:                     # the save run itself
        _bitwise(res[1], want)
    for res in runs:
        assert res["start_event"] == sum(want["chunk_log"]) - sum(
            res["chunk_log"])
        for key in ("receipts", "ran"):
            assert res[key] == want[key][-len(res[key]):], key
        for x, y in zip(res["preds"], want["preds"][-k:]):
            np.testing.assert_array_equal(x, y)
        for (e, x), (f, y) in zip(res["snapshots"], want["snapshots"][-k:]):
            assert e == f
            np.testing.assert_array_equal(x, y)
        for x, y in zip(res["state"], want["state"], strict=True):
            np.testing.assert_array_equal(x, y)


def test_save_at_two_ranks_resumes_in_jax(jax_resume, one):
    got, want = jax_resume(), one[1]
    assert got["start"] == sum(want["chunk_log"]) - sum(got["chunk_log"])
    assert got["receipts"] == want["receipts"][-len(got["receipts"]):]
    v = want["snapshots"][-1][1]
    assert np.abs(got["v"] - v).max() <= SERVE_RTOL * np.abs(v).max()


def test_jax_record_resumes_at_two_ranks_as_at_one(world2, one):
    for res in world2:
        _bitwise(res[3], one[2])


def test_threaded_learner_drains_bitwise_ten_times(world2, one):
    coop = one[3]
    for res in world2:
        for run in res[4:4 + THREADED_REPS]:
            assert run["chunk_log"] == coop["chunk_log"]
            for x, y in zip(run["state"], coop["state"], strict=True):
                np.testing.assert_array_equal(x, y)
            assert run["learner_threads"] == (1, False)
            assert run["stops"] == [sum(coop["chunk_log"])]


def test_crash_on_one_rank_heals_and_loses_nothing(world2, one):
    coop = one[3]
    for rank, res in enumerate(world2):
        run = res[4 + THREADED_REPS]
        health = run["stats"]["health"]
        assert health["learner_restarts"] == (1 if rank == 1 else 0)
        assert run["chunk_log"] == coop["chunk_log"]
        for x, y in zip(run["state"], coop["state"], strict=True):
            np.testing.assert_array_equal(x, y)


def test_breaker_on_one_rank_latches_every_rank(world2):
    runs = [res[5 + THREADED_REPS] for res in world2]
    for rank, run in enumerate(runs):
        assert run["breaker"] and run["stats"]["health"]["breaker_tripped"]
        assert run["receipts"][-1] == ((0, 2), "breaker")
        assert run["ran"] == [0]
        assert run["preds"][-1].shape == (3,)
        stop = run["stops"][0]
        if rank == 1:
            assert "InjectedFault" in stop
        else:
            assert isinstance(stop, int)
    assert len({tuple(r["chunk_log"]) for r in runs}) == 1
    for x, y in zip(runs[0]["state"], runs[1]["state"], strict=True):
        np.testing.assert_array_equal(x, y)


def test_distributed_prox_stream_bitwise_iterate_close(world2, one):
    want = one[4]
    for res in world2:
        run = res[6 + THREADED_REPS]
        for key in ("receipts", "chunk_log", "ran"):
            assert run[key] == want[key], key
        for i in (2, 3, 4, 6, 7, 8):       # task ring .. key: the stream
            np.testing.assert_array_equal(run["state"][i], want["state"][i])
        for (e, x), (f, y) in zip(run["snapshots"], want["snapshots"]):
            assert e == f
            np.testing.assert_allclose(x, y, rtol=DIST_RTOL, atol=DIST_ATOL)


def test_capped_threaded_feedback_folds_rank_0s_receipts(world2, data):
    xs, ys = data
    rows = {t: [(xs[t], ys[t])] for t in range(T)}
    lead = world2[0][7 + THREADED_REPS]
    for (_, t, x, y), ((acc, rej), reason) in zip(CAPPED, lead["receipts"],
                                                  strict=True):
        assert rej >= 1 and reason == "admission"
        rows[int(t[0])].append((x[:acc], y[:acc]))
    want = {t: [np.concatenate(a) for a in zip(*r)] for t, r in rows.items()}
    counts = [len(want[t][1]) for t in range(T)]
    for rank, res in enumerate(world2):
        run = res[7 + THREADED_REPS]
        assert run["counts"] == counts
        assert run["chunk_log"] == lead["chunk_log"]
        assert run["stops"] == lead["stops"]
        sx, sy, sc = run["store"]
        for j, t in enumerate(range(rank * T // 2, (rank + 1) * T // 2)):
            assert sc[j] == counts[t]
            np.testing.assert_array_equal(sx[j, :counts[t]], want[t][0])
            np.testing.assert_array_equal(sy[j, :counts[t]], want[t][1])


def test_killed_rank_makes_the_world_raise_naming_the_signal(data):
    xs, ys = data
    rng = np.random.default_rng(6)
    ops = [("feedback", rng.integers(0, T, 6)), ("kill", 1), ("step",),
           ("step",)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_world(session, 2,
                  _spec(xs, ys, [dict(cfg=_cfg(xs, ys), serve=SERVE,
                                      ops=ops)]),
                  device="cpu", timeout=WORLD_TIMEOUT_S,
                  collective_timeout=COLLECTIVE_TIMEOUT_S, verbose=False)
    msg = str(err.value)
    assert "rank 1 was killed by SIGKILL" in msg
    assert "rank 0 of 2 failed" in msg
    assert time.monotonic() - t0 < COLLECTIVE_TIMEOUT_S + 20


def test_exit_reason_names_signals():
    assert exit_reason(-9).startswith("was killed by SIGKILL")
    assert exit_reason(-15) == "was killed by SIGTERM"
    assert exit_reason(3) == "exited with code 3"
