"""The port's task-sharded engine on one rank, in this process, against the
reference's sharded engine on its 1-device "tasks" mesh and against the
port's batch engine: the contracts of tests/test_amtl_sharded.py.

  * one rank: every collective is the identity, so the port's sharded
    engine is bitwise its batch engine (iterate, W, objectives,
    residuals, the full state, both proxes, the decoupled cadence);
  * against JAX's sharded engine on `make_task_mesh(1)`: the integer and
    host leaves bitwise, the tensors within ENGINE_RTOL of their scale
    (float32 products summed in another order, tests/test_torch_engine.py);
  * the shard-local pieces: `shard_local_tasks`, the sentinel drop of
    `amtl_event_batch_sharded`, `rollback_columns_shard`, the
    rank-distributed SVT bitwise the serial one at one rank, `ProxPlan`;
  * the validation surface of `make_engine`/`validate_config`/
    `make_task_mesh`.

Multi-rank worlds (gloo) are tests/test_torch_sharded_world.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import amtl as jamtl  # noqa: E402
from repro.core import prox as jprox  # noqa: E402
from repro.distributed.sharding import TASK_AXIS as J_AXIS  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.mesh import make_task_mesh as j_make_task_mesh  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import operators, prng  # noqa: E402
from repro_torch.core.prox import (ProxPlan, sketch_width,  # noqa: E402
                                   svt_randomized, svt_randomized_dist)
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.interop import LEAVES, state_to_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.mesh import TaskMesh, make_task_mesh  # noqa: E402

ENGINE_RTOL = 1e-4
HOST_FIELDS = ("task_ring", "ptr", "event", "history.buf", "history.count",
               "key")
OFFSETS = np.array([3.0, 1.0, 0.0, 2.0, 4.0], np.float32)


@pytest.fixture(scope="module")
def problems(small_problem):
    xs, ys = np.asarray(small_problem.xs), np.asarray(small_problem.ys)
    return small_problem, rt.problem_from_numpy(xs, ys, "lstsq", "nuclear",
                                                0.1, device="cpu")


@pytest.fixture(scope="module")
def mesh1():
    return make_task_mesh(1, device="cpu")


def _cfg_pair(jp, tau, bsz, **kw):
    """(batch cfg, sharded cfg) of the port, aligned prox_every ==
    event_batch, and the same pair of the reference."""
    kw = dict(eta=1.0 / jp.lipschitz(), eta_k=0.7, tau=tau, engine="batch",
              prox_every=bsz, event_batch=bsz, **kw)
    t = rt.AMTLConfig(**kw)
    j = jamtl.AMTLConfig(**kw)
    return (t, t._replace(engine="sharded"), j._replace(engine="sharded"))


def _w0(jp):
    return np.zeros((jp.dim, jp.num_tasks), np.float32)


def _assert_equal_states(a, b):
    for name, x, y in zip(LEAVES, state_to_numpy(a), state_to_numpy(b),
                          strict=True):
        np.testing.assert_array_equal(x, y, err_msg=name)


def _assert_matches_jax(jax_state, port_state):
    theirs = dict(zip(LEAVES, (np.asarray(a) for a in
                               jax.tree_util.tree_leaves(jax_state))))
    mine = dict(zip(LEAVES, state_to_numpy(port_state)))
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(mine[f], theirs[f], err_msg=f)
    for f in ("v", "delta_ring", "p_cache"):
        assert mine[f].shape == theirs[f].shape, f
        want = theirs[f].astype(np.float64)
        scale = max(np.abs(want).max(initial=0.0), 1e-30)
        err = np.abs(mine[f] - want).max(initial=0.0)
        assert err <= ENGINE_RTOL * scale, (f, err, scale)


# ----------------------------------------------------------- equivalence
@pytest.mark.parametrize("tau,bsz", [(0, 4), (3, 5), (8, 5), (3, 1), (4, 10)])
def test_sharded_1shard_bitwise_matches_batch(problems, mesh1, tau, bsz):
    """One rank: iterates, W, objectives and residuals bitwise the batch
    engine's (event_batch past the ring depth and event_batch 1 too); the
    iterate within ENGINE_RTOL of JAX's sharded engine."""
    jp, tp = problems
    batch_cfg, sharded_cfg, jcfg = _cfg_pair(jp, tau, bsz)
    key = prng.key_from_seed(3)
    epe = 10 if bsz != 4 else 8
    batch = rt.amtl_solve(tp, batch_cfg, _w0(jp), key, num_epochs=8,
                          events_per_epoch=epe, device="cpu")
    sharded = rt.amtl_solve(tp, sharded_cfg, _w0(jp), key, num_epochs=8,
                            events_per_epoch=epe, mesh=mesh1)
    for f in ("v", "w", "objectives", "residuals"):
        assert torch.equal(getattr(batch, f), getattr(sharded, f)), f
    jres = jamtl.amtl_solve(jp, jcfg, jnp.asarray(_w0(jp)),
                            jax.random.PRNGKey(3), num_epochs=8,
                            events_per_epoch=epe, mesh=j_make_task_mesh(1))
    want = np.asarray(jres.v, np.float64)
    assert np.abs(sharded.v.numpy() - want).max() \
        <= ENGINE_RTOL * np.abs(want).max()


def test_sharded_bitwise_under_delays_dynamic_step_and_sketch(problems,
                                                              mesh1):
    """The folded sketch key, the delay-adaptive step and the history
    replay through the sharded path bitwise."""
    jp, tp = problems
    batch_cfg, sharded_cfg, _ = _cfg_pair(jp, 4, 5, dynamic_step=True,
                                          prox_rank=5)
    key = prng.key_from_seed(11)
    batch = rt.amtl_solve(tp, batch_cfg, _w0(jp), key, num_epochs=6,
                          delay_offsets=OFFSETS, device="cpu")
    sharded = rt.amtl_solve(tp, sharded_cfg, _w0(jp), key, num_epochs=6,
                            delay_offsets=OFFSETS, mesh=mesh1)
    assert torch.equal(batch.v, sharded.v)


def test_sharded_state_stream_matches_batch(problems, mesh1):
    """The private undo ring, the global-id task ring, pointer, counter,
    key and history equal the batch engine's bitwise, and JAX's sharded
    state within ENGINE_RTOL (its host leaves bitwise)."""
    jp, tp = problems
    batch_cfg, sharded_cfg, jcfg = _cfg_pair(jp, 3, 5)
    key = prng.key_from_seed(5)
    b = rt.amtl_events_only(tp, batch_cfg, _w0(jp), key, 25, device="cpu")
    s = rt.amtl_events_only(tp, sharded_cfg, _w0(jp), key, 25, mesh=mesh1)
    assert isinstance(s, rt.core.ShardedAMTLState)
    assert s.delta_ring.shape[0] == 1
    assert torch.equal(b.v, s.v) and torch.equal(b.delta_ring,
                                                 s.delta_ring[0])
    np.testing.assert_array_equal(b.task_ring, s.task_ring)
    assert (b.ptr, b.event) == (s.ptr, s.event) and s.event == 25
    np.testing.assert_array_equal(b.key, s.key)
    np.testing.assert_array_equal(b.history.buf, s.history.buf)
    np.testing.assert_array_equal(b.history.count, s.history.count)
    js = jamtl.amtl_events_only(jp, jcfg, jnp.asarray(_w0(jp)),
                                jax.random.PRNGKey(5), 25,
                                mesh=j_make_task_mesh(1))
    _assert_matches_jax(js, s)


# ------------------------------------------- rank-distributed server prox
def test_svt_randomized_dist_1shard_bitwise_matches_serial():
    """One rank: both collectives are the identity and Omega unsplit, so
    the distributed SVT is bitwise the serial one; both within 1e-5 of
    the prox's scale of JAX's (ROADMAP's SVD/QR tolerance)."""
    d, num_t, rank = 24, 8, 4
    w = np.random.default_rng(0).standard_normal((d, num_t)).astype(
        np.float32)
    key = np.asarray(jax.random.PRNGKey(42))
    plan = ProxPlan(num_tasks=num_t, n_local=num_t)
    for mesh in (None, make_task_mesh(1, device="cpu")):
        got = svt_randomized_dist(torch.as_tensor(w), 0.3, rank=rank,
                                  key=key, plan=plan, mesh=mesh)
        want = svt_randomized(torch.as_tensor(w), 0.3, rank=rank, key=key)
        assert torch.equal(got, want)
    theirs = np.asarray(jprox.svt_randomized(
        jnp.asarray(w), jnp.float32(0.3), rank=rank,
        key=jax.random.PRNGKey(42)), np.float64)
    assert np.abs(got.numpy() - theirs).max() <= 1e-5 * np.abs(theirs).max()


@pytest.mark.parametrize("tau,bsz,k", [(3, 5, 1), (3, 4, 2), (0, 2, 3)])
def test_sharded_distributed_prox_1shard_bitwise_matches_batch(
        problems, mesh1, tau, bsz, k):
    """prox_mode="distributed" at one rank: bitwise the batch engine's
    full state, the carried prox cache at k > 1 too; JAX's distributed
    sharded state within ENGINE_RTOL."""
    jp, tp = problems
    batch_cfg, sharded_cfg, jcfg = _cfg_pair(jp, tau, bsz, prox_rank=4)
    batch_cfg = batch_cfg._replace(prox_every=k * bsz)
    dist_cfg = sharded_cfg._replace(prox_every=k * bsz,
                                    prox_mode="distributed")
    key = prng.key_from_seed(9)
    n = 8 * bsz * k
    b = rt.amtl_events_only(tp, batch_cfg, _w0(jp), key, n, device="cpu")
    s = rt.amtl_events_only(tp, dist_cfg, _w0(jp), key, n, mesh=mesh1)
    assert torch.equal(b.v, s.v) and torch.equal(b.p_cache, s.p_cache)
    assert torch.equal(b.delta_ring, s.delta_ring[0])
    np.testing.assert_array_equal(b.task_ring, s.task_ring)
    np.testing.assert_array_equal(b.key, s.key)
    js = jamtl.amtl_events_only(
        jp, jcfg._replace(prox_every=k * bsz, prox_mode="distributed"),
        jnp.asarray(_w0(jp)), jax.random.PRNGKey(9), n,
        mesh=j_make_task_mesh(1))
    _assert_matches_jax(js, s)


def test_sharded_distributed_prox_dynamic_step_and_straggler_offsets(
        problems, mesh1):
    jp, tp = problems
    batch_cfg, sharded_cfg, _ = _cfg_pair(jp, 4, 5, dynamic_step=True,
                                          prox_rank=5)
    key = prng.key_from_seed(11)
    batch = rt.amtl_solve(tp, batch_cfg, _w0(jp), key, num_epochs=6,
                          delay_offsets=OFFSETS, device="cpu")
    dist = rt.amtl_solve(tp, sharded_cfg._replace(prox_mode="distributed"),
                         _w0(jp), key, num_epochs=6, delay_offsets=OFFSETS,
                         mesh=mesh1)
    assert torch.equal(batch.v, dist.v)


def test_prox_plan_comm_bytes_beats_replicated_gather():
    d, num_t, rank = 8192, 128, 16
    plan = ProxPlan(num_tasks=num_t, n_local=num_t // 8)
    p = sketch_width(rank, d, num_t)
    assert plan.comm_bytes_per_refresh(d, rank) == (d * p + p * num_t) * 4
    assert plan.comm_bytes_per_refresh(d, rank) < d * num_t * 4
    jplan = jprox.ProxPlan(axis=J_AXIS, num_tasks=num_t, n_local=num_t // 8)
    assert plan.comm_bytes_per_refresh(d, rank) \
        == jplan.comm_bytes_per_refresh(d, rank)


# ------------------------------------------------- shard-local primitives
def test_rollback_columns_shard_tiles_the_batch_rollback():
    """Per-rank rollbacks concatenated in rank order equal the global one
    bitwise, every (ptr, nu), duplicates across rank boundaries."""
    d, num_t, tau, n_shards = 6, 8, 4, 4
    n_local = num_t // n_shards
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal((d, num_t)).astype(np.float32))
    ring = torch.as_tensor(rng.standard_normal((tau + 1, d)).astype(
        np.float32))
    task_ring = np.array([1, 6, 1, 0, 7], np.int32)
    for ptr in range(tau + 1):
        for nu in range(tau + 1):
            want = operators.rollback_columns_batch(v, ring, task_ring, ptr,
                                                    nu, tau)
            got = torch.cat([operators.rollback_columns_shard(
                v[:, s * n_local:(s + 1) * n_local], ring, task_ring, ptr,
                nu, tau, s * n_local) for s in range(n_shards)], dim=1)
            assert torch.equal(got, want), (ptr, nu)


def test_shard_local_tasks_sentinel_and_ownership():
    """Bitwise the reference's, for numpy and tensor ids."""
    tasks = np.array([0, 3, 4, 7, 2], np.int32)
    want_l, want_o = jref.shard_local_tasks(jnp.asarray(tasks),
                                            jnp.asarray(4, jnp.int32), 4)
    for got_l, got_o in (ref.shard_local_tasks(tasks, 4, 4),
                         ref.shard_local_tasks(torch.as_tensor(tasks), 4, 4)):
        np.testing.assert_array_equal(np.asarray(got_o), want_o)
        np.testing.assert_array_equal(np.asarray(got_l), want_l)
        assert np.asarray(got_l).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(want_l), [4, 4, 0, 3, 4])


def test_sharded_batch_dispatch_drops_sentinel_events():
    """Another rank's events (sentinel n_local) leave the block untouched;
    the block and every undo row bitwise the reference's sharded op, and
    the owned ones bitwise the unsharded op's."""
    d, num_t, b = 16, 6, 8
    n_local, t_off = 3, 3
    rng = np.random.default_rng(0)
    v = rng.standard_normal((d, num_t)).astype(np.float32)
    p, g = (rng.standard_normal((d, b)).astype(np.float32) for _ in range(2))
    eks = rng.uniform(0.1, 0.9, b).astype(np.float32)
    tasks = np.array([0, 4, 4, 1, 5, 0, 3, 4], np.int32)
    local, owned = ref.shard_local_tasks(tasks, t_off, n_local)
    blk = v[:, t_off:t_off + n_local]
    got_v, got_u = ops.amtl_event_batch_sharded(
        torch.as_tensor(blk.copy()), torch.as_tensor(p), torch.as_tensor(g),
        torch.as_tensor(local), 0.05, torch.as_tensor(eks))
    want_v, want_u = jops.amtl_event_batch_sharded(
        jnp.asarray(blk), jnp.asarray(p), jnp.asarray(g), jnp.asarray(local),
        jnp.float32(0.05), jnp.asarray(eks))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    full_v, full_u = ops.amtl_event_batch(
        torch.as_tensor(v.copy()), torch.as_tensor(p), torch.as_tensor(g),
        torch.as_tensor(tasks), 0.05, torch.as_tensor(eks))
    np.testing.assert_array_equal(got_v.numpy(),
                                  full_v[:, t_off:t_off + n_local].numpy())
    np.testing.assert_array_equal(got_u.numpy()[owned],
                                  full_u.numpy()[owned])


def test_placement_tables_and_one_rank_collectives():
    """The four placement classes name the state's leaves; the prox cache
    is `columns` only when the distributed prox carries it; at one rank
    every collective returns its input itself."""
    specs = sharding.task_shard_specs()
    assert set(specs) == {"per_task", "columns", "per_shard", "replicated"}
    leaves = {leaf for names in specs.values() for leaf in names}
    assert {"v", "delta_ring", "task_ring", "ptr", "event", "history",
            "key", "xs", "ys", "row_counts"} == leaves
    assert sharding.prox_cache_spec("distributed", True) == "columns"
    for mode, carried in (("distributed", False), ("replicated", True),
                          ("replicated", False)):
        assert sharding.prox_cache_spec(mode, carried) == "replicated"
    x = torch.ones(3, 2)
    for mesh in (None, make_task_mesh(1, device="cpu")):
        assert sharding.gather_columns(x, mesh) is x
        assert sharding.gather_shards(x, mesh) is x
        assert sharding.sum_partials(x, mesh) is x
        sharding.barrier(mesh)


# ----------------------------------------------------- validation surface
def test_sharded_requires_prox_alignment(problems, mesh1):
    jp, tp = problems
    cfg = rt.AMTLConfig(eta=1.0 / jp.lipschitz(), eta_k=0.7, tau=3,
                        engine="sharded", prox_every=2, event_batch=4)
    with pytest.raises(ValueError, match=r"prox_every \(2\) must be a "
                                         r"multiple of event_batch \(4\)"):
        rt.amtl_solve(tp, cfg, _w0(jp), prng.key_from_seed(0), num_epochs=1,
                      events_per_epoch=4, mesh=mesh1)


def test_distributed_prox_requires_sharded_engine(problems):
    cfg = rt.AMTLConfig(eta=0.05, eta_k=0.7, tau=3, engine="batch",
                        prox_every=4, event_batch=4, prox_rank=4,
                        prox_mode="distributed")
    with pytest.raises(ValueError, match="no shards to distribute over"):
        rt.validate_config(cfg, problems[1].reg_name)


def test_distributed_prox_requires_prox_rank(problems):
    cfg = rt.AMTLConfig(eta=0.05, eta_k=0.7, tau=3, engine="sharded",
                        prox_every=4, event_batch=4, prox_mode="distributed")
    with pytest.raises(ValueError, match="prox_rank must be set"):
        rt.validate_config(cfg, problems[1].reg_name)


def test_unknown_prox_mode_rejected(problems):
    cfg = rt.AMTLConfig(eta=0.05, eta_k=0.7, tau=3, engine="sharded",
                        prox_every=4, event_batch=4, prox_rank=4,
                        prox_mode="sketchy")
    with pytest.raises(ValueError, match="unknown prox_mode"):
        rt.validate_config(cfg, problems[1].reg_name)


def test_sharded_requires_tasks_axis(problems):
    """A mesh that is not the port's 1-D "tasks" TaskMesh is refused."""
    jp, tp = problems
    cfg = rt.AMTLConfig(eta=1.0 / jp.lipschitz(), eta_k=0.7, tau=3,
                        engine="sharded", prox_every=4, event_batch=4)
    with pytest.raises(ValueError, match=r"'tasks' TaskMesh"):
        rt.amtl_solve(tp, cfg, _w0(jp), prng.key_from_seed(0), num_epochs=1,
                      events_per_epoch=4, mesh=("data", "model"))


def test_mesh_rejected_for_unsharded_engines(problems, mesh1):
    jp, tp = problems
    cfg = rt.AMTLConfig(eta=1.0 / jp.lipschitz(), eta_k=0.7, tau=3,
                        engine="delta")
    with pytest.raises(ValueError, match=r"mesh is only meaningful.*sharded"):
        rt.amtl_solve(tp, cfg, _w0(jp), prng.key_from_seed(0), num_epochs=1,
                      device="cpu", mesh=mesh1)


def test_make_task_mesh_validates_device_count():
    """Outside a torch.distributed world there is one rank: 0 or 2 ranks
    are refused as the reference refuses more shards than devices; the
    default is the 1-rank mesh, on the CUDA card unless asked for the
    CPU."""
    with pytest.raises(ValueError, match=r"num_shards must be in"):
        make_task_mesh(2, device="cpu")
    with pytest.raises(ValueError, match=r"num_shards must be in"):
        make_task_mesh(0, device="cpu")
    mesh = make_task_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_task_mesh()


def test_divisibility_and_device_checked_eagerly(problems):
    """T must divide over the ranks (checked from the mesh, before any
    collective), and a device other than the mesh's is refused."""
    jp, tp = problems
    cfg = rt.AMTLConfig(eta=0.1, eta_k=0.5, tau=2, engine="sharded",
                        event_batch=2, prox_every=2)
    three = TaskMesh(None, 0, 3, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="divisible"):
        rt.make_engine(tp, cfg, mesh=three)
    with pytest.raises(ValueError, match="mesh's device"):
        rt.make_engine(tp, cfg, device="cuda:0",
                       mesh=make_task_mesh(1, device="cpu"))
