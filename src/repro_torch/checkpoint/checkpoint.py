"""Checkpointing of the port's states (port of
`repro/checkpoint/checkpoint.py`): one npz record a step, in the
reference's format, so a record written by either package restores in
the other.

A state is a tree of NamedTuples, dicts, lists and tuples over leaves
that are tensors, numpy arrays or Python scalars.  It is flattened as the
reference's `jax.tree_util.tree_flatten_with_path` flattens the same
tree: a NamedTuple field is keyed ".name", a dict entry by its key (dict
keys in sorted order), a list or tuple entry by its index, the path
joined by "||", and None holds no leaf.  So the delta and batch states
write `.v`, `.delta_ring`, `.task_ring`, `.ptr`, `.event`, `.p_cache`,
`.history||.buf`, `.history||.count` and `.key`, the dense state `.ring`,
`.ptr`, `.event`, `.history||...` and `.key`, a TaskStore `.xs`, `.ys` and
`.row_counts`.

Leaves are written in the reference's dtypes: a tensor or a numpy array
as its own dtype, a Python int as a 0-d int32 (the engines keep `ptr` and
`event` as host ints where the reference keeps int32 scalars), any other
scalar as `np.asarray` gives it.  `restore(like=)` gives
every leaf back in its `like` leaf's kind: a tensor on that tensor's
device (on the caller's current CUDA stream), a numpy array, or a Python
scalar.  A record whose key set, shapes or dtypes disagree with `like`
fails loudly, naming the drifted entries.

Integrity, as in the reference: `save` embeds a per-leaf CRC32 manifest
under the reserved `__manifest__` key and fsyncs the record before the
`os.replace`, so a record lands whole or not at all; `verify` checks one
record against its manifest; `restore` runs the same check and raises
`CheckpointCorruptError` naming the damaged leaves; `latest_valid_step`
walks records newest first and returns the newest that verifies.
Records written before the manifest existed still `restore` (no CRC
cover) but fail `verify`.

A sharded engine state (`core.amtl.ShardedAMTLState`) is written as the
reference's global view, the record JAX writes under its mesh.  On a
mesh of n > 1 ranks (`save(..., mesh=, cfg=)`, a collective every rank
calls) the ranks' states are gathered, rank 0 writes the record, and
every rank waits for it at a barrier; `restore(..., mesh=, cfg=)` reads
the record in every rank and gives each its own view.  At one rank the
state is the global view and needs no mesh.  A record of the sharded,
batch or delta engine's state restores into any of them, at any number
of ranks: the undo rings, the one leaf whose layout depends on the rank
count, are re-placed by the owner of each slot's task
(`core.amtl.place_rings`).

A record too large for one process to hold is written and read in
pieces: `save_streamed` writes leaves from chunks (one chunk in memory
at a time, the CRCs taken on the way), `read_rows` reads a block of a
leaf's leading axis straight from the file with the CRC32 of its bytes,
and `crc32_concat` joins the blocks' CRCs into the leaf's, which the
manifest holds (`read_manifest`).  The record is the one `save` writes.
"""
from __future__ import annotations

import json
import os
import re
import struct
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

_SEP = "||"
MANIFEST_KEY = "__manifest__"
_TMP_RE = re.compile(r"step_\d+\.npz\.tmp\.npz$")
_STEP_RE = re.compile(r"step_(\d+)\.npz$")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint record failed integrity verification.

    `path` is the offending record; `damaged` lists the flattened leaf
    keys whose bytes disagree with the manifest (empty when the record
    is unreadable as a whole: torn zip, missing manifest).
    """

    def __init__(self, path: str, damaged: list[str], detail: str):
        self.path = path
        self.damaged = list(damaged)
        suffix = f" (damaged leaves: {self.damaged})" if self.damaged else ""
        super().__init__(f"corrupt checkpoint {path}: {detail}{suffix}")


# ------------------------------------------------------------- the tree --

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[list[tuple[str, Any]]]:
    """(key, child) pairs of an inner node in the reference's flatten
    order; None for a leaf."""
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _leaves(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(flattened key, leaf) pairs in flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(_SEP.join(prefix), tree)]
    out = []
    for key, child in kids:
        out.extend(_leaves(child, prefix + (key,)))
    return out


def _rebuild(tree, leaves):
    """`tree`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(c, leaves) for c in tree)
    return next(leaves)


def _host(key: str, leaf) -> np.ndarray:
    """A leaf as the numpy array the record holds."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"leaf {key!r}: bfloat16 tensors have no numpy "
                            "dtype to write")
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: _host(key, leaf) for key, leaf in _leaves(tree)}


def _like_spec(leaf) -> tuple[tuple, np.dtype]:
    """(shape, numpy dtype) a `like` leaf expects of its record."""
    if isinstance(leaf, torch.Tensor):
        dtype = torch.empty(0, dtype=leaf.dtype).numpy().dtype
        return tuple(leaf.shape), dtype
    if isinstance(leaf, (bool, int, float)):
        return (), _host("", leaf).dtype
    arr = np.asarray(leaf)
    return arr.shape, arr.dtype


def _as_like(arr: np.ndarray, leaf):
    """`arr` in the kind of the `like` leaf."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(leaf.device)
    if isinstance(leaf, bool):
        return bool(arr)
    if isinstance(leaf, int):
        return int(arr)
    if isinstance(leaf, float):
        return float(arr)
    return arr


def _crc(arr: np.ndarray) -> int:
    """CRC32 of the array's C-order bytes (`tobytes()` without the copy)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _manifest_array(flat: dict[str, np.ndarray]) -> np.ndarray:
    crcs = {k: _crc(v) for k, v in flat.items()}
    blob = json.dumps(crcs, sort_keys=True).encode("utf-8")
    return np.frombuffer(blob, dtype=np.uint8)


def _sweep_tmp_litter(ckpt_dir: str, keep: str) -> None:
    # A process that died between np.savez and os.replace leaves its
    # step_*.npz.tmp.npz behind; the next save in the same directory
    # sweeps it.  Saves within one directory are serialized by the
    # callers (the server checkpoints under its state lock), so the only
    # matching tmp file not ours is litter.
    for fname in os.listdir(ckpt_dir):
        if _TMP_RE.match(fname) and fname != keep:
            try:
                os.remove(os.path.join(ckpt_dir, fname))
            except OSError:
                pass  # racing sweeper or permissions: litter, not data


def _map_sharded(tree, fn):
    """`tree` with every sharded engine state in it replaced by fn(it)."""
    from repro_torch.core.amtl import ShardedAMTLState
    if isinstance(tree, ShardedAMTLState):
        return fn(tree)
    if _is_namedtuple(tree):
        return type(tree)(*(_map_sharded(getattr(tree, f), fn)
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_sharded(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_sharded(c, fn) for c in tree)
    return tree


def _global_view(tree, mesh, cfg):
    """`tree` with its sharded states gathered over `mesh` (a collective);
    the tree itself without a mesh of n > 1 ranks."""
    if mesh is None or mesh.size == 1:
        return tree
    from repro_torch.core.amtl import gather_state
    return _map_sharded(tree, lambda st: gather_state(st, cfg, mesh))


# ------------------------------------------------------------ the API --

def save(ckpt_dir: str, step: int, tree: Any,
         keep_last: Optional[int] = None, *, mesh=None, cfg=None) -> str:
    """Write `tree` as `step_<step>.npz`; optionally rotate old steps.

    The record embeds a per-leaf CRC32 manifest and is flushed and
    fsynced before the atomic `os.replace`; stale `step_*.npz.tmp.npz`
    litter is swept first.  `keep_last=k` deletes `step_*.npz` records
    beyond the k newest (by step number) after the write lands, by the
    filename that matched; the record just written is never deleted.
    None keeps everything.

    With a `mesh` of n > 1 ranks (and the sharded engine's `cfg`) every
    rank calls it: the sharded states are gathered, rank 0 writes, and
    every rank returns once the record is in place.
    """
    if keep_last is not None and keep_last < 1:
        raise ValueError(f"keep_last must be >= 1 (got {keep_last}); "
                         "use keep_last=None to keep every checkpoint")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    if mesh is not None and mesh.size > 1:
        from repro_torch.distributed.sharding import barrier
        tree = _global_view(tree, mesh, cfg)
        if mesh.rank == 0:
            save(ckpt_dir, step, tree, keep_last)
        barrier(mesh)
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = path + ".tmp.npz"
    _sweep_tmp_litter(ckpt_dir, keep=os.path.basename(tmp))
    flat = _flatten(tree)
    payload = dict(flat)
    payload[MANIFEST_KEY] = _manifest_array(flat)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _rotate(ckpt_dir, path, keep_last)
    return path


def _rotate(ckpt_dir: str, path: str, keep_last: Optional[int]) -> None:
    """Delete the records beyond the `keep_last` newest, never `path`."""
    if keep_last is None:
        return
    just_written = os.path.basename(path)
    records = sorted(((int(m.group(1)), f) for f in os.listdir(ckpt_dir)
                      if (m := _STEP_RE.match(f))),
                     key=lambda r: (r[0], r[1] == just_written))
    for _, fname in records[:-keep_last]:
        if fname != just_written:
            os.remove(os.path.join(ckpt_dir, fname))


def save_streamed(ckpt_dir: str, step: int, leaves: list,
                  keep_last: Optional[int] = None) -> str:
    """Write `step_<step>.npz` from leaves given in chunks, the record
    `save` writes (npy members, the CRC32 manifest, fsync, atomic
    replace, rotation) with one chunk in memory at a time.

    `leaves` is a list of (flattened key, shape, dtype, chunks); `chunks`
    yields arrays whose C-order bytes, in turn, are the leaf's (taken as
    they are, whatever the arrays' own dtypes).
    """
    if keep_last is not None and keep_last < 1:
        raise ValueError(f"keep_last must be >= 1 (got {keep_last}); "
                         "use keep_last=None to keep every checkpoint")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    _sweep_tmp_litter(ckpt_dir, keep=os.path.basename(tmp))
    crcs = {}
    with open(tmp, "wb") as f:
        with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as record:
            for key, shape, dtype, chunks in leaves:
                dtype = np.dtype(dtype)
                want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                crc, n = 0, 0
                with record.open(key + ".npy", "w", force_zip64=True) as m:
                    np.lib.format.write_array_header_1_0(m, {
                        "descr": np.lib.format.dtype_to_descr(dtype),
                        "fortran_order": False, "shape": tuple(shape)})
                    for chunk in chunks:
                        b = np.ascontiguousarray(chunk).reshape(-1) \
                            .view(np.uint8)
                        m.write(b)
                        crc = zlib.crc32(b, crc)
                        n += b.nbytes
                if n != want:
                    raise ValueError(f"leaf {key!r}: {n} bytes streamed, "
                                     f"its shape {tuple(shape)} holds {want}")
                crcs[key] = crc
            blob = json.dumps(crcs, sort_keys=True).encode("utf-8")
            with record.open(MANIFEST_KEY + ".npy", "w") as m:
                np.lib.format.write_array(
                    m, np.frombuffer(blob, dtype=np.uint8))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _rotate(ckpt_dir, path, keep_last)
    return path


def read_manifest(path: str) -> dict[str, int]:
    """The CRC32 manifest of a record, read alone (no leaf is loaded)."""
    try:
        with np.load(path) as data:
            if MANIFEST_KEY not in data.files:
                raise CheckpointCorruptError(
                    path, [], "record carries no integrity manifest")
            return json.loads(bytes(data[MANIFEST_KEY]).decode("utf-8"))
    except (CheckpointCorruptError, FileNotFoundError):
        raise
    except Exception as e:
        raise CheckpointCorruptError(path, [], f"unreadable record: {e!r}")


def read_rows(path: str, key: str, lo: int, hi: int) -> tuple:
    """Rows [lo, hi) of the leading axis of leaf `key` of the record at
    `path`, read from the file alone: (the rows, the CRC32 of their bytes,
    the leaf's shape).  The leaf must be stored uncompressed, as `save`
    and `save_streamed` store it."""
    try:
        with zipfile.ZipFile(path) as record:
            info = record.getinfo(key + ".npy")
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(path, [key], f"unreadable record: {e!r}")
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{path}: leaf {key!r} is compressed; a block of it "
                         "cannot be read on its own")
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(30)
        if len(head) < 30 or head[:4] != b"PK\x03\x04":
            raise CheckpointCorruptError(path, [key], "bad local header")
        name_len, extra_len = struct.unpack("<HH", head[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        major, _ = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if major == 1
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        if fortran or not shape or not 0 <= lo <= hi <= shape[0]:
            raise ValueError(f"{path}: leaf {key!r} of shape {shape} "
                             f"(fortran {fortran}) has no rows [{lo}, {hi})")
        row = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
        out = np.empty((hi - lo,) + tuple(shape[1:]), dtype)
        f.seek(f.tell() + lo * row)
        view = out.reshape(-1).view(np.uint8)
        if f.readinto(view) != view.nbytes:
            raise CheckpointCorruptError(path, [key], "the leaf is cut short")
    return out, zlib.crc32(view), tuple(shape)


def _gf2_times(mat: list, vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: list) -> list:
    return [_gf2_times(mat, row) for row in mat]


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32 of A || B from crc32(A), crc32(B) and len(B) bytes (zlib's
    crc32_combine: crc1 is shifted through len2 zero bytes by squaring the
    one-zero-bit operator over GF(2))."""
    if len2 <= 0:
        return crc1
    odd = [0xEDB88320] + [1 << n for n in range(31)]   # one zero bit
    even = _gf2_square(odd)                             # two
    odd = _gf2_square(even)                             # four
    while True:
        even = _gf2_square(odd)
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


def crc32_concat(parts) -> int:
    """The CRC32 of byte blocks joined in order, from each block's
    (CRC32, length)."""
    crc = 0
    for c, n in parts:
        crc = _crc32_combine(crc, int(c), int(n))
    return crc


def record_steps(ckpt_dir: str) -> list[int]:
    """Distinct recorded steps, newest first ([] for no/absent dir)."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = {int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(f))}
    return sorted(steps, reverse=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = record_steps(ckpt_dir)
    return steps[0] if steps else None


def verify(path: str) -> dict[str, int]:
    """Check one record's per-leaf CRC32 manifest without rebuilding it.

    Returns the verified manifest (flat leaf key -> CRC32).  Raises
    `CheckpointCorruptError` when the record is unreadable, carries no
    manifest, names leaves absent from the manifest or vice versa, or any
    leaf's bytes disagree with its CRC.  FileNotFoundError passes through:
    a missing record is not a corrupt one.
    """
    try:
        with np.load(path) as data:
            if MANIFEST_KEY not in data.files:
                raise CheckpointCorruptError(
                    path, [], "record carries no integrity manifest "
                    "(pre-manifest save or truncated write)")
            manifest = json.loads(bytes(data[MANIFEST_KEY]).decode("utf-8"))
            keys = [k for k in data.files if k != MANIFEST_KEY]
            drifted = (sorted(set(keys) - set(manifest))
                       + sorted(set(manifest) - set(keys)))
            if drifted:
                raise CheckpointCorruptError(
                    path, drifted, "leaf set disagrees with the manifest")
            damaged = []
            for key in keys:
                try:
                    ok = _crc(data[key]) == manifest[key]
                except Exception:  # zip's own CRC / truncation mid-entry
                    ok = False
                if not ok:
                    damaged.append(key)
            if damaged:
                raise CheckpointCorruptError(
                    path, damaged, "leaf bytes fail their CRC32")
            return manifest
    except (CheckpointCorruptError, FileNotFoundError):
        raise
    except Exception as e:  # bad zip, json rot, short central directory
        raise CheckpointCorruptError(path, [], f"unreadable record: {e!r}")


def latest_valid_step(ckpt_dir: str, like: Any = None) -> Optional[int]:
    """Newest step whose record verifies; None when no record does.

    With `like`, a record whose manifest key set disagrees with `like`'s
    flattened layout is skipped too.
    """
    want = {k for k, _ in _leaves(like)} if like is not None else None
    for step in record_steps(ckpt_dir):
        try:
            manifest = verify(_resolve_step_path(ckpt_dir, step))
        except (CheckpointCorruptError, FileNotFoundError):
            continue
        if want is not None and set(manifest) != want:
            continue
        return step
    return None


def _ring_layout(ckpt_dir: str, step: int, like, mesh, cfg):
    """(the global `like` with the record's undo-ring shape, the shards it
    is placed for or None) when `like` is a delta, batch or sharded state
    whose rings the record holds in another layout; else None."""
    from repro_torch.core.amtl import (BatchAMTLState, DeltaAMTLState,
                                       ShardedAMTLState, global_template)
    if not isinstance(like, (BatchAMTLState, DeltaAMTLState,
                             ShardedAMTLState)):
        return None
    glob = like
    if isinstance(like, ShardedAMTLState) and mesh is not None:
        glob = global_template(like, cfg, mesh)
    try:
        with zipfile.ZipFile(_resolve_step_path(ckpt_dir, step)) as record:
            with record.open(".delta_ring.npy") as f:
                major, _ = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if major == 1
                        else np.lib.format.read_array_header_2_0)
                shape = tuple(read(f)[0])
    except Exception:
        return None                     # `restore` itself reports it
    want = tuple(glob.delta_ring.shape)
    if shape == want or len(shape) not in (2, 3) \
            or shape[-2:] != want[-2:]:
        return None
    return (glob._replace(delta_ring=glob.delta_ring.new_empty(shape)),
            want[0] if len(want) == 3 else None)


def _resolve_step_path(ckpt_dir: str, step: int) -> str:
    """The on-disk filename for `step`, whatever its zero padding: the
    canonical `step_{step:08d}.npz` on ties, else the lexicographically
    first match; a step with no record resolves to the canonical name."""
    padded = f"step_{step:08d}.npz"
    if os.path.isdir(ckpt_dir):
        matches = sorted(
            f for f in os.listdir(ckpt_dir)
            if (m := _STEP_RE.match(f))
            and int(m.group(1)) == step)
        if matches and padded not in matches:
            return os.path.join(ckpt_dir, matches[0])
    return os.path.join(ckpt_dir, padded)


def restore(ckpt_dir: str, step: int, like: Any, *, mesh=None,
            cfg=None) -> Any:
    """The tree of record `step`, in `like`'s structure and leaf kinds.

    Raises ValueError when the record's keys, a leaf's shape or its dtype
    differ from `like`'s (naming the leaf), and `CheckpointCorruptError`
    when the record is unreadable or a leaf fails its manifest CRC.

    With a `mesh` of n > 1 ranks (and the sharded engine's `cfg`) every
    rank calls it with its own `like`: the record holds the global view,
    and each rank gets its own view of each sharded state.  An engine
    state whose undo rings the record holds for another rank count is
    re-placed (see the module doc).
    """
    placed = _ring_layout(ckpt_dir, step, like, mesh, cfg)
    if placed is not None:
        from repro_torch.core.amtl import (ShardedAMTLState, local_state,
                                           place_rings)
        template, shards = placed
        full = restore(ckpt_dir, step, template)
        full = full._replace(delta_ring=place_rings(
            full.delta_ring, full.task_ring, full.v.shape[1], shards))
        if isinstance(like, ShardedAMTLState):
            return local_state(full, cfg, mesh)
        return full
    if mesh is not None and mesh.size > 1:
        from repro_torch.core.amtl import global_template, local_state
        full = restore(ckpt_dir, step, _map_sharded(
            like, lambda st: global_template(st, cfg, mesh)))
        return _map_sharded(full, lambda st: local_state(st, cfg, mesh))
    path = _resolve_step_path(ckpt_dir, step)
    try:
        data = np.load(path)
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(path, [], f"unreadable record: {e!r}")
    with data:
        manifest = None
        if MANIFEST_KEY in data.files:
            try:
                manifest = json.loads(
                    bytes(data[MANIFEST_KEY]).decode("utf-8"))
            except Exception as e:
                raise CheckpointCorruptError(
                    path, [MANIFEST_KEY], f"unreadable manifest: {e!r}")
        flat_like = _leaves(like)
        want_keys = [k for k, _ in flat_like]
        missing = [k for k in want_keys if k not in data]
        extra = sorted(set(data.files) - set(want_keys) - {MANIFEST_KEY})
        if missing or extra:
            raise ValueError(
                f"checkpoint {path} does not match the `like` tree layout: "
                f"missing keys {missing}, unexpected keys {extra} — was the "
                "state's structure changed since this checkpoint was saved?")
        leaves = []
        damaged = []
        for key, leaf in flat_like:
            try:
                arr = data[key]
            except Exception:  # zip-level CRC failure / truncated entry
                damaged.append(key)
                continue
            if manifest is not None and (
                    key not in manifest or _crc(arr) != manifest[key]):
                damaged.append(key)
                continue
            shape, dtype = _like_spec(leaf)
            if arr.shape != shape:
                raise ValueError(
                    f"checkpoint {path}: leaf {key!r} has shape {arr.shape} "
                    f"but `like` expects {shape}")
            if arr.dtype != dtype:
                raise ValueError(
                    f"checkpoint {path}: leaf {key!r} has dtype {arr.dtype} "
                    f"but `like` expects {dtype} — dtype drift would "
                    "silently change the resumed computation")
            leaves.append(_as_like(arr, leaf))
        if damaged:
            raise CheckpointCorruptError(
                path, damaged, "leaf bytes fail their CRC32")
    return _rebuild(like, iter(leaves))
