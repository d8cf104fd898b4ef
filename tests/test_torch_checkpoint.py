"""The port's checkpointing (`repro_torch.checkpoint`) against the
reference's (`repro.checkpoint`).

  * Every case of tests/test_checkpoint_integrity.py and
    test_checkpoint_retention.py, run against both packages (the JAX tree
    of jnp arrays, the port's of tensors): CRC manifest, typed corruption
    errors, the newest-valid scan, rotation, padding and litter.
  * The engine states of the dense, delta and batch engines flatten to
    the reference's keys, dtypes and shapes.
  * A JAX engine record restores into the port's engine, and the next
    `run` continues the same event stream; the port's record restores
    into JAX the same way.  Host leaves (`task_ring`, `ptr`, `event`,
    `history`, `key`) bitwise; float leaves (`v`, `delta_ring`,
    `p_cache`, `ring`) within ENGINE_RTOL of their scale (ROADMAP's
    engine tolerance: float32 products summed in another order).
  * A JAX record restored by the port and saved again has byte-equal
    leaves and the same manifest; TaskStore records cross both ways
    bitwise.
"""
import json
import os
import re
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.core import amtl as jamtl  # noqa: E402
from repro.data import TaskStore as JStore  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch.checkpoint import CheckpointCorruptError  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import TaskStore  # noqa: E402
from repro_torch.interop import (DENSE_LEAVES, LEAVES,  # noqa: E402
                                 state_to_numpy)
from repro_torch.serve import faults as tfaults  # noqa: E402

ENGINE_RTOL = 1e-4


class _Pkg:
    """One package's checkpoint module, damage tools and tree leaves."""

    def __init__(self, name, ck, faults, array, error):
        self.name, self.ck, self.faults = name, ck, faults
        self.array, self.error = array, error

    def __repr__(self):
        return self.name


JAX = _Pkg("jax", jck, jfaults,
           lambda a, dtype: jnp.asarray(a, dtype),
           jck.CheckpointCorruptError)
PORT = _Pkg("torch", tck, tfaults,
            lambda a, dtype: torch.as_tensor(np.asarray(a, dtype)),
            CheckpointCorruptError)


@pytest.fixture(params=[JAX, PORT], ids=repr)
def pkg(request):
    return request.param


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------ integrity, both packages

def _tree(pkg):
    return {"v": pkg.array(np.arange(12.0).reshape(3, 4), np.float32),
            "nested": {"counts": pkg.array(np.ones(5), np.int32)}}


def test_save_embeds_manifest_and_roundtrips(pkg, tmp_path):
    d = str(tmp_path)
    tree = _tree(pkg)
    path = pkg.ck.save(d, 3, tree)
    manifest = pkg.ck.verify(path)
    assert set(manifest) == {"v", "nested||counts"}
    with np.load(path) as record:
        assert "__manifest__" in record.files
    restored = pkg.ck.restore(d, 3, tree)
    np.testing.assert_array_equal(_np(restored["v"]), _np(tree["v"]))
    np.testing.assert_array_equal(_np(restored["nested"]["counts"]),
                                  _np(tree["nested"]["counts"]))


def test_truncated_record_raises_typed_error(pkg, tmp_path):
    d = str(tmp_path)
    tree = _tree(pkg)
    path = pkg.ck.save(d, 1, tree)
    pkg.faults.truncate_record(path)
    with pytest.raises(pkg.error):
        pkg.ck.verify(path)
    with pytest.raises(pkg.error):
        pkg.ck.restore(d, 1, tree)


def test_bit_rot_names_the_damaged_leaf(pkg, tmp_path):
    d = str(tmp_path)
    tree = _tree(pkg)
    path = pkg.ck.save(d, 1, tree)
    pkg.faults.corrupt_leaf(path, key="v")
    with zipfile.ZipFile(path) as z:    # the container still opens
        assert z.testzip() is None
    with pytest.raises(pkg.error) as err:
        pkg.ck.verify(path)
    assert err.value.damaged == ["v"]
    with pytest.raises(pkg.error) as err:
        pkg.ck.restore(d, 1, tree)
    assert "v" in err.value.damaged


def test_missing_file_stays_file_not_found(pkg, tmp_path):
    with pytest.raises(FileNotFoundError):
        pkg.ck.verify(str(tmp_path / "step_00000001.npz"))


def test_legacy_record_restores_but_fails_verify(pkg, tmp_path):
    d = str(tmp_path)
    tree = _tree(pkg)
    legacy = os.path.join(d, "step_00000004.npz")
    np.savez(legacy, **{"v": _np(tree["v"]),
                        "nested||counts": _np(tree["nested"]["counts"])})
    restored = pkg.ck.restore(d, 4, tree)
    np.testing.assert_array_equal(_np(restored["v"]), _np(tree["v"]))
    with pytest.raises(pkg.error):
        pkg.ck.verify(legacy)
    assert pkg.ck.latest_valid_step(d, like=tree) is None


def test_latest_valid_step_skips_damaged_newest(pkg, tmp_path):
    d = str(tmp_path)
    tree = _tree(pkg)
    for s in (10, 20, 30):
        pkg.ck.save(d, s, tree)
    assert pkg.ck.latest_valid_step(d, like=tree) == 30
    pkg.faults.corrupt_leaf(os.path.join(d, "step_00000030.npz"))
    assert pkg.ck.latest_valid_step(d, like=tree) == 20
    pkg.faults.truncate_record(os.path.join(d, "step_00000020.npz"))
    assert pkg.ck.latest_valid_step(d, like=tree) == 10
    pkg.faults.corrupt_leaf(os.path.join(d, "step_00000010.npz"))
    assert pkg.ck.latest_valid_step(d, like=tree) is None
    assert pkg.ck.latest_step(d) == 30


def test_latest_valid_step_checks_layout_against_like(pkg, tmp_path):
    d = str(tmp_path)
    pkg.ck.save(d, 50, {"other": pkg.array(np.zeros(2), np.float32)})
    assert pkg.ck.latest_valid_step(d) == 50
    assert pkg.ck.latest_valid_step(d, like=_tree(pkg)) is None


def test_record_steps_newest_first(pkg, tmp_path):
    d = str(tmp_path)
    tree = _tree(pkg)
    for s in (7, 3, 11):
        pkg.ck.save(d, s, tree)
    assert pkg.ck.record_steps(d) == [11, 7, 3]
    assert pkg.ck.record_steps(str(tmp_path / "missing")) == []


def test_manifest_key_is_reserved_not_extra(pkg, tmp_path):
    d = str(tmp_path)
    tree = _tree(pkg)
    pkg.ck.save(d, 2, tree)
    pkg.ck.restore(d, 2, tree)
    extra = dict(tree)
    extra["rogue"] = pkg.array(np.zeros(1), np.float32)
    pkg.ck.save(d, 6, extra)
    with pytest.raises(ValueError, match="unexpected keys"):
        pkg.ck.restore(d, 6, tree)


# ------------------------------------------------- retention, both packages

def _rtree(pkg, step):
    return {"v": pkg.array(np.full((3, 2), float(step)), np.float32),
            "event": pkg.array(step, np.int32)}


def _steps_on_disk(d):
    return sorted(int(m.group(1)) for f in os.listdir(d)
                  if (m := re.match(r"step_(\d+)\.npz$", f)))


def test_default_keeps_everything(pkg, tmp_path):
    d = str(tmp_path)
    for s in range(5):
        pkg.ck.save(d, s, _rtree(pkg, s))
    assert _steps_on_disk(d) == [0, 1, 2, 3, 4]


def test_keep_last_rotates_oldest(pkg, tmp_path):
    d = str(tmp_path)
    for s in (10, 20, 30, 40, 50):
        pkg.ck.save(d, s, _rtree(pkg, s), keep_last=3)
    assert _steps_on_disk(d) == [30, 40, 50]
    got = pkg.ck.restore(d, 40, like=_rtree(pkg, 0))
    np.testing.assert_array_equal(_np(got["v"]), _np(_rtree(pkg, 40)["v"]))
    assert pkg.ck.latest_step(d) == 50


def test_keep_last_one_keeps_only_newest(pkg, tmp_path):
    d = str(tmp_path)
    for s in range(4):
        pkg.ck.save(d, s, _rtree(pkg, s), keep_last=1)
    assert _steps_on_disk(d) == [3]


def test_keep_last_counts_out_of_order_saves(pkg, tmp_path):
    d = str(tmp_path)
    for s in (5, 9):
        pkg.ck.save(d, s, _rtree(pkg, s), keep_last=2)
    path = pkg.ck.save(d, 1, _rtree(pkg, 1), keep_last=2)
    assert os.path.exists(path)
    assert _steps_on_disk(d) == [1, 5, 9]
    pkg.ck.save(d, 12, _rtree(pkg, 12), keep_last=2)
    assert _steps_on_disk(d) == [9, 12]


def test_keep_last_applies_when_enabled_late(pkg, tmp_path):
    d = str(tmp_path)
    for s in range(6):
        pkg.ck.save(d, s, _rtree(pkg, s))
    pkg.ck.save(d, 6, _rtree(pkg, 6), keep_last=2)
    assert _steps_on_disk(d) == [5, 6]


def test_keep_last_ignores_foreign_files(pkg, tmp_path):
    d = str(tmp_path)
    (tmp_path / "notes.txt").write_text("keep me")
    (tmp_path / "step_zzz.npz").write_text("not a step record")
    for s in range(3):
        pkg.ck.save(d, s, _rtree(pkg, s), keep_last=1)
    assert _steps_on_disk(d) == [2]
    assert (tmp_path / "notes.txt").exists()
    assert (tmp_path / "step_zzz.npz").exists()


def test_keep_last_rotates_mixed_padding_records(pkg, tmp_path):
    d = str(tmp_path)
    pkg.ck.save(d, 5, _rtree(pkg, 5))
    os.rename(os.path.join(d, "step_00000005.npz"),
              os.path.join(d, "step_5.npz"))
    for s in (6, 7, 8):
        pkg.ck.save(d, s, _rtree(pkg, s), keep_last=2)
    assert sorted(os.listdir(d)) == ["step_00000007.npz",
                                     "step_00000008.npz"]


def test_keep_last_same_step_other_padding_is_rotatable(pkg, tmp_path):
    d = str(tmp_path)
    pkg.ck.save(d, 3, _rtree(pkg, 3))
    os.rename(os.path.join(d, "step_00000003.npz"),
              os.path.join(d, "step_3.npz"))
    path = pkg.ck.save(d, 3, _rtree(pkg, 3), keep_last=1)
    assert os.path.exists(path)
    assert os.listdir(d) == ["step_00000003.npz"]


def test_restore_resolves_mixed_padding_record(pkg, tmp_path):
    d = str(tmp_path)
    pkg.ck.save(d, 5, _rtree(pkg, 5))
    os.rename(os.path.join(d, "step_00000005.npz"),
              os.path.join(d, "step_5.npz"))
    step = pkg.ck.latest_step(d)
    assert step == 5
    got = pkg.ck.restore(d, step, like=_rtree(pkg, 0))
    np.testing.assert_array_equal(_np(got["v"]), _np(_rtree(pkg, 5)["v"]))


def test_restore_prefers_padded_name_on_ties(pkg, tmp_path):
    d = str(tmp_path)
    pkg.ck.save(d, 7, _rtree(pkg, 7))
    os.rename(os.path.join(d, "step_00000007.npz"),
              os.path.join(d, "step_7.npz"))
    pkg.ck.save(d, 7, {"v": pkg.array(np.full((3, 2), 99.0), np.float32),
                       "event": pkg.array(7, np.int32)})
    got = pkg.ck.restore(d, 7, like=_rtree(pkg, 0))
    np.testing.assert_array_equal(_np(got["v"]),
                                  np.full((3, 2), 99.0, np.float32))


def test_restore_missing_step_names_canonical_file(pkg, tmp_path):
    pkg.ck.save(str(tmp_path), 1, _rtree(pkg, 1))
    with pytest.raises(FileNotFoundError, match="step_00000009.npz"):
        pkg.ck.restore(str(tmp_path), 9, like=_rtree(pkg, 0))


def test_keep_last_validates(pkg, tmp_path):
    with pytest.raises(ValueError, match="keep_last must be >= 1"):
        pkg.ck.save(str(tmp_path), 0, _rtree(pkg, 0), keep_last=0)
    assert _steps_on_disk(str(tmp_path)) == []


def test_save_sweeps_stale_tmp_litter(pkg, tmp_path):
    d = str(tmp_path)
    pkg.ck.save(d, 1, _rtree(pkg, 1))
    litter = tmp_path / "step_00000099.npz.tmp.npz"
    litter.write_bytes(b"torn half-written record")
    (tmp_path / "notes.tmp").write_text("not checkpoint litter")
    path = pkg.ck.save(d, 2, _rtree(pkg, 2))
    assert not litter.exists()
    assert (tmp_path / "notes.tmp").exists()
    assert _steps_on_disk(d) == [1, 2]
    got = pkg.ck.restore(d, 2, like=_rtree(pkg, 0))
    np.testing.assert_array_equal(_np(got["v"]), _np(_rtree(pkg, 2)["v"]))
    assert os.path.exists(path)


# --------------------------------------------------- the port's leaf kinds

def test_restore_gives_leaves_in_the_like_kinds(tmp_path):
    """Tensors come back as tensors, numpy as numpy, host ints as ints,
    written as the reference's int32; a drifted leaf is named."""
    tree = {"t": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "n": np.arange(4, dtype=np.uint32), "i": 7, "f": 0.5,
            "b": True, "none": None, "seq": (3, [np.int32(4)])}
    path = tck.save(str(tmp_path), 1, tree)
    with np.load(path) as record:
        assert record["i"].dtype == np.int32 and record["i"].shape == ()
        assert record["f"].dtype == np.float64
        assert record["b"].dtype == np.bool_
        assert record["seq||0"].dtype == np.int32
        assert "none" not in record.files
    got = tck.restore(str(tmp_path), 1, like=tree)
    assert isinstance(got["t"], torch.Tensor) and torch.equal(got["t"],
                                                              tree["t"])
    assert isinstance(got["n"], np.ndarray) and got["n"].dtype == np.uint32
    assert got["i"] == 7 and type(got["i"]) is int
    assert got["f"] == 0.5 and got["b"] is True and got["none"] is None
    assert got["seq"][0] == 3 and isinstance(got["seq"], tuple)
    assert list(got) == list(tree)
    drift = dict(tree, t=torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="leaf 't' has dtype float32"):
        tck.restore(str(tmp_path), 1, like=drift)
    drift = dict(tree, n=np.zeros(5, np.uint32))
    with pytest.raises(ValueError, match="leaf 'n' has shape"):
        tck.restore(str(tmp_path), 1, like=drift)


# --------------------------------------------- engine records across both

ENGINES = {
    "dense": dict(engine="dense"),
    "delta": dict(engine="delta", prox_every=2),
    "batch": dict(engine="batch", event_batch=2, prox_every=4),
    # on both sides' default mesh: one device, one rank
    "sharded": dict(engine="sharded", event_batch=2, prox_every=4,
                    prox_rank=3),
}


def _problems(small_problem):
    xs, ys = np.asarray(small_problem.xs), np.asarray(small_problem.ys)
    return small_problem, rt.problem_from_numpy(xs, ys, "lstsq", "nuclear",
                                                0.1, device="cpu")


def _engines(small_problem, engine):
    jp, tp = _problems(small_problem)
    kw = dict(eta=1.0 / jp.lipschitz(), eta_k=0.7, tau=3, **ENGINES[engine])
    je = jamtl.make_engine(jp, jamtl.AMTLConfig(**kw))
    te = rt.make_engine(tp, rt.AMTLConfig(**kw), device="cpu")
    w0 = np.zeros((jp.dim, jp.num_tasks), np.float32)
    js = je.init(jnp.asarray(w0), jax.random.PRNGKey(3))
    ts = te.init(w0, prng.key_from_seed(3))
    return je, te, js, ts


def _assert_leaves_match(engine, jax_state, port_state):
    names = DENSE_LEAVES if engine == "dense" else LEAVES
    theirs = [np.asarray(a) for a in jax.tree_util.tree_leaves(jax_state)]
    for name, a, b in zip(names, theirs, state_to_numpy(port_state),
                          strict=True):
        if a.dtype.kind == "f" and name not in ("history.buf",):
            scale = max(np.abs(a).max(initial=0.0), 1e-30)
            err = np.abs(a.astype(np.float64) - b).max(initial=0.0)
            assert err <= ENGINE_RTOL * scale, (name, err, scale)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_state_record_has_the_reference_layout(small_problem, engine,
                                               tmp_path):
    je, te, js, ts = _engines(small_problem, engine)
    jpath = jck.save(str(tmp_path / "jax"), 0, js)
    tpath = tck.save(str(tmp_path / "torch"), 0, ts)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert a.files == b.files
        for key in a.files:
            assert (a[key].dtype, a[key].shape) == (b[key].dtype,
                                                    b[key].shape), key
    assert set(tck.verify(tpath)) == set(jck.verify(jpath))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_jax_record_resumes_in_the_port(small_problem, engine, tmp_path):
    """JAX runs n events and saves; the port restores into its own engine
    and runs m more: the state is JAX's run(init, n + m)."""
    je, te, js, ts = _engines(small_problem, engine)
    n, m = 8, 6
    jck.save(str(tmp_path), n, je.run(js, None, n))
    resumed = tck.restore(str(tmp_path), n, like=ts)
    assert isinstance(resumed.ptr, int) and isinstance(resumed.event, int)
    assert resumed.event == n
    _assert_leaves_match(engine, je.run(js, None, n + m),
                         te.run(resumed, None, m))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_port_record_resumes_in_jax(small_problem, engine, tmp_path):
    je, te, js, ts = _engines(small_problem, engine)
    n, m = 8, 6
    tck.save(str(tmp_path), n, te.run(ts, None, n))
    resumed = jck.restore(str(tmp_path), n, like=js)
    _assert_leaves_match(engine, je.run(resumed, None, m),
                         te.run(ts, None, n + m))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_jax_record_saved_again_by_the_port_is_byte_equal(small_problem,
                                                          engine, tmp_path):
    je, te, js, ts = _engines(small_problem, engine)
    jpath = jck.save(str(tmp_path / "jax"), 4, je.run(js, None, 4))
    tpath = tck.save(str(tmp_path / "torch"), 4,
                     tck.restore(str(tmp_path / "jax"), 4, like=ts))
    with np.load(jpath) as a, np.load(tpath) as b:
        assert a.files == b.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].tobytes() == b[key].tobytes(), key
        assert json.loads(bytes(a["__manifest__"])) == \
            json.loads(bytes(b["__manifest__"]))


def test_store_records_cross_both_ways_bitwise(tmp_path):
    rng = np.random.default_rng(5)
    sizes = [3, 9, 1, 6]
    xs = [rng.standard_normal((n, 7)).astype(np.float32) for n in sizes]
    ys = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    mine = TaskStore.from_ragged(xs, ys, "lstsq", "nuclear", 0.1)
    theirs = JStore.from_ragged(xs, ys, "lstsq", "nuclear", 0.1)
    ids = rng.integers(0, 4, size=12)
    f = rng.standard_normal((12, 7)).astype(np.float32)
    y = rng.standard_normal(12).astype(np.float32)
    mine.append(ids, f, y)
    theirs.append(ids, f, y)
    assert mine.capacity == theirs.capacity == 18
    theirs.save(str(tmp_path / "jax"), 5)
    mine.save(str(tmp_path / "torch"), 5)
    from_jax = TaskStore.restore(str(tmp_path / "jax"), 5, "lstsq",
                                 "nuclear", 0.1)
    from_port = JStore.restore(str(tmp_path / "torch"), 5, "lstsq",
                               "nuclear", 0.1)
    for got in (from_jax.state(), from_port.state()):
        for a, b in zip(got, theirs.state(), strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert from_jax.capacity == from_port.capacity == 18
    with np.load(tmp_path / "jax" / "step_00000005.npz") as a, \
            np.load(tmp_path / "torch" / "step_00000005.npz") as b:
        assert json.loads(bytes(a["__manifest__"])) == \
            json.loads(bytes(b["__manifest__"]))


def test_store_restore_of_a_torn_record_is_typed(tmp_path):
    store = TaskStore.from_ragged([np.ones((2, 3))], [np.ones(2)], "lstsq",
                                  "nuclear", 0.1)
    path = store.save(str(tmp_path), 1)
    back = TaskStore.restore(str(tmp_path), 1, "lstsq", "nuclear", 0.1)
    np.testing.assert_array_equal(back.state().xs, store.state().xs)
    tfaults.truncate_record(path)
    with pytest.raises(CheckpointCorruptError):
        TaskStore.restore(str(tmp_path), 1, "lstsq", "nuclear", 0.1)
    with pytest.raises(FileNotFoundError):
        TaskStore.restore(str(tmp_path), 2, "lstsq", "nuclear", 0.1)
