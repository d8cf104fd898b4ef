"""The pieces the lockstep server's records are made of, on the CPU:

  * `checkpoint.save_streamed` writes the record `save` writes (it
    verifies, the port's and JAX's `TaskStore.restore` read it bitwise);
  * `checkpoint.read_rows` reads any block of rows of a leaf, and
    `crc32_concat` joins the blocks' CRC32s into the manifest's;
  * `core.amtl.place_rings` re-places undo rings between rank counts and
    the one ring of the batch engine, owned slots bitwise;
  * `TaskStore.append(..., capacity=)` grows a shard with the whole store,
    and its undo shrinks it back.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.store import TaskStore as JStore  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.core import place_rings  # noqa: E402
from repro_torch.data import TaskStore  # noqa: E402


def _store(seed=0, t=8, cap=5, d=3):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((t, cap, d)).astype(np.float32)
    ys = rng.standard_normal((t, cap)).astype(np.float32)
    counts = rng.integers(0, cap + 1, t).astype(np.int32)
    return TaskStore(xs, ys, counts, "lstsq", "nuclear", 0.1)


@pytest.mark.parametrize("pieces", [1, 2, 3])
def test_streamed_record_is_the_saved_record(tmp_path, pieces):
    store = _store()
    st = store.state()
    split = np.array_split(np.arange(st.xs.shape[0]), pieces)
    leaves = [(".xs", st.xs.shape, np.float32, [st.xs[i] for i in split]),
              (".ys", st.ys.shape, np.float32, [st.ys[i] for i in split]),
              (".row_counts", st.row_counts.shape, np.int32,
               [st.row_counts])]
    path = checkpoint.save_streamed(str(tmp_path), 7, leaves)
    store.save(str(tmp_path / "plain"), 7)
    assert checkpoint.verify(path) == checkpoint.verify(
        str(tmp_path / "plain" / "step_00000007.npz"))
    back = TaskStore.restore(str(tmp_path), 7, "lstsq", "nuclear", 0.1)
    theirs = JStore.restore(str(tmp_path), 7, "lstsq", "nuclear", 0.1)
    for a, b, c in zip(back.state(), theirs.state(), st, strict=True):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(np.asarray(b), c)


def test_streamed_record_refuses_a_short_leaf(tmp_path):
    with pytest.raises(ValueError, match="bytes streamed"):
        checkpoint.save_streamed(str(tmp_path), 1, [
            (".xs", (4, 2), np.float32, [np.zeros((3, 2), np.float32)])])


@pytest.mark.parametrize("bounds", [(0, 8), (0, 4, 8), (0, 1, 1, 5, 8)])
def test_rows_read_alone_join_into_the_manifest(tmp_path, bounds):
    store = _store(1)
    store.save(str(tmp_path), 3)
    path = str(tmp_path / "step_00000003.npz")
    manifest = checkpoint.read_manifest(path)
    for key, full in ((".xs", store.state().xs), (".ys", store.state().ys)):
        parts = [checkpoint.read_rows(path, key, lo, hi)
                 for lo, hi in zip(bounds, bounds[1:])]
        np.testing.assert_array_equal(
            np.concatenate([p[0] for p in parts]), full)
        assert all(p[2] == full.shape for p in parts)
        assert checkpoint.crc32_concat(
            [(p[1], p[0].nbytes) for p in parts]) == manifest[key]


def test_crc32_concat_is_zlibs_crc_of_the_join():
    rng = np.random.default_rng(2)
    blocks = [rng.bytes(n) for n in (0, 1, 7, 1000, 65536, 3)]
    want = zlib.crc32(b"".join(blocks))
    assert checkpoint.crc32_concat(
        [(zlib.crc32(b), len(b)) for b in blocks]) == want


def test_rows_of_a_missing_leaf_or_past_the_end_raise(tmp_path):
    _store(3).save(str(tmp_path), 4)
    path = str(tmp_path / "step_00000004.npz")
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.read_rows(path, ".nope", 0, 1)
    with pytest.raises(ValueError, match="no rows"):
        checkpoint.read_rows(path, ".xs", 0, 9)


def _rings(n, t=8, depth=4, d=3, seed=4):
    rng = np.random.default_rng(seed)
    task_ring = rng.integers(0, t, depth)
    ring = torch.as_tensor(rng.standard_normal((n, depth, d)),
                           dtype=torch.float32)
    return ring, task_ring


@pytest.mark.parametrize("n, m", [(2, 4), (4, 2), (2, 1), (1, 2), (4, 4)])
def test_place_rings_keeps_each_owned_slot(n, m):
    ring, task_ring = _rings(n)
    one = place_rings(ring, task_ring, 8, None)
    owner_n = task_ring // (8 // n)
    for s, o in enumerate(owner_n):
        assert torch.equal(one[s], ring[o, s])
    moved = place_rings(ring, task_ring, 8, m)
    owner_m = task_ring // (8 // m)
    for s in range(len(task_ring)):
        for r in range(m):
            want = ring[owner_n[s], s] if r == owner_m[s] else \
                torch.zeros(3)
            assert torch.equal(moved[r, s], want)
    assert torch.equal(place_rings(moved, task_ring, 8, None), one)


def test_append_grows_a_shard_with_the_whole_store():
    shard = _store(5, t=2, cap=4)
    before = shard.state()
    undo = shard.append_undoable(np.zeros(0, np.int64),
                                 np.zeros((0, 3), np.float32),
                                 np.zeros(0, np.float32), capacity=7)
    assert shard.capacity == 8
    np.testing.assert_array_equal(shard.row_counts, before.row_counts)
    shard.rollback(undo)
    for a, b in zip(shard.state(), before, strict=True):
        np.testing.assert_array_equal(a, b)
    shard.append([1], np.ones((1, 3), np.float32), [2.0], capacity=3)
    assert shard.capacity == 4
