"""`launch/shapes.py`, `configs.all_configs` and the meta-device dry run
(`launch/dryrun.py`) against the reference, on the CPU, at full size
(nothing is allocated: the reference's trees come from `jax.eval_shape`,
the port's from meta tensors).

- `applicable`'s verdicts, `batch_struct`'s and `decode_structs`'
  names, shapes and dtypes equal the reference's for all 40
  (arch x shape) combos; `concrete_batch` draws those names, shapes,
  dtypes and ranges;
- `params_total` and `params_active` equal the reference's
  `dryrun.param_counts` (mirrored here on `jax.eval_shape` of
  `init_params`) for all ten archs, and `param_bytes` the bytes of its
  leaves;
- `opt_state_bytes` equal the bytes of the reference's
  `default_optimizer(cfg).init` on the train shape;
- `cache_bytes` equal the bytes of the reference's
  `jax.eval_shape(serving.init_cache)` at every applicable decode combo,
  with and without the int8 cache.

`repro.launch.dryrun` is not imported: its first lines set XLA_FLAGS to
512 host devices, which would change the device count of every later
test in the same process.
"""
import dataclasses
import math
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_configs as ref_all_configs  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import shapes as ref_shapes  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models import serving as ref_serving  # noqa: E402
from repro_torch.configs import ARCH_NAMES, all_configs  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402

COMBOS = [(a, s) for a in ARCH_NAMES for s in shapes.SHAPES]


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", k)))


def dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


def struct_bytes(tree) -> int:
    return sum(math.prod(x.shape) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(tree))


def ref_param_counts(cfg) -> tuple[float, float, int]:
    """`repro.launch.dryrun.param_counts`, and the leaves' bytes."""
    struct = jax.eval_shape(partial(ref_init, cfg=cfg),
                            jax.random.PRNGKey(0))
    total = expert_n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(struct)[0]:
        n = math.prod(leaf.shape)
        total += n
        names = [_key(k) for k in path]
        if "moe" in names and names[-1] in ("w_in", "w_out", "w_gate"):
            expert_n += n
    active = total
    if cfg.moe:
        active = total - expert_n + expert_n * cfg.moe.top_k \
            / cfg.moe.num_experts
    return float(total), float(active), struct_bytes(struct)


def test_all_configs_are_the_references():
    got, want = all_configs(), ref_all_configs()
    assert list(got) == list(ARCH_NAMES) and set(got) == set(want)
    for name, cfg in got.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[name])


@pytest.mark.parametrize("arch,shape", COMBOS,
                         ids=[f"{a}-{s}" for a, s in COMBOS])
def test_shapes_match_the_reference(arch, shape):
    cfg, rcfg = all_configs()[arch], ref_config(arch)
    spec, rspec = shapes.SHAPES[shape], ref_shapes.SHAPES[shape]
    assert dataclasses.asdict(spec) == dataclasses.asdict(rspec)
    assert shapes.applicable(cfg, spec) == ref_shapes.applicable(rcfg, rspec)
    got = {k: (s, dtype_name(d))
           for k, (s, d) in shapes.batch_struct(cfg, spec).items()}
    want = {k: (tuple(v.shape), dtype_name(v.dtype))
            for k, v in ref_shapes.batch_struct(rcfg, rspec).items()}
    assert got == want
    assert [(s, dtype_name(d)) for s, d in shapes.decode_structs(
        cfg, spec)] == [(tuple(v.shape), dtype_name(v.dtype))
                        for v in ref_shapes.decode_structs(rcfg, rspec)]


def test_concrete_batch_draws_the_structs():
    cfg = all_configs()["hubert-xlarge"].reduced()
    spec = shapes.ShapeSpec("tiny", "train", 16, 3)
    for c in (cfg, all_configs()["llama-3.2-vision-11b"].reduced()):
        batch = shapes.concrete_batch(c, spec, seed=4)
        assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == \
            {k: s for k, s in shapes.batch_struct(c, spec).items()}
        for k, v in batch.items():
            if k in ("tokens", "targets"):
                assert 0 <= int(v.min()) and int(v.max()) < c.vocab_size
            if k == "task_ids":
                assert int(v.max()) < c.mtl.num_tasks
        again = shapes.concrete_batch(c, spec, seed=4)
        assert all(torch.equal(v, again[k]) for k, v in batch.items())
    assert batch["vision_embeds"].abs().max() < 1.0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_and_bytes_match_the_reference(arch):
    total, active, nbytes = ref_param_counts(ref_config(arch))
    got = dryrun.run_combo(arch, "train_4k")
    assert got["status"] == "ok" and got["mesh"] == "1"
    assert (got["params_total"], got["params_active"]) == (total, active)
    assert got["param_bytes"] == nbytes
    assert dryrun.param_counts(all_configs()[arch]) == (total, active)
    rcfg = ref_config(arch)
    struct = jax.eval_shape(partial(ref_init, cfg=rcfg),
                            jax.random.PRNGKey(0))
    opt = jax.eval_shape(jsteps.default_optimizer(rcfg).init, struct)
    assert got["opt_state_bytes"] == struct_bytes(opt)
    assert got["batch_bytes"] == struct_bytes(ref_shapes.batch_struct(
        rcfg, ref_shapes.SHAPES["train_4k"]))


@pytest.mark.parametrize("kv_int8", [False, True], ids=["model", "int8"])
def test_cache_bytes_match_the_reference(kv_int8):
    rows = dryrun.main(["--all"] + (["--kv-int8"] if kv_int8 else []))
    assert len(rows) == 40
    assert sum(r["status"] == "ok" for r in rows) == 33
    checked = 0
    for r in rows:
        spec = ref_shapes.SHAPES[r["shape"]]
        rcfg = ref_config(r["arch"])
        if kv_int8:
            rcfg = dataclasses.replace(rcfg, kv_cache_dtype="int8")
        ok, reason = ref_shapes.applicable(rcfg, spec)
        assert r["status"] == ("ok" if ok else "skip")
        assert r.get("reason", "") == reason
        assert r["kv_cache"] == ("int8" if kv_int8 else "model")
        if not ok or spec.kind != "decode":
            assert "cache_bytes" not in r
            continue
        want = jax.eval_shape(partial(ref_serving.init_cache, rcfg,
                                      spec.batch, spec.seq))
        assert r["cache_bytes"] == struct_bytes(want), r
        checked += 1
    assert checked == 13          # 9 archs at decode_32k, 4 at long_500k
    by = {(r["arch"], r["shape"]): r for r in rows}
    granite = by[("granite-8b", "decode_32k")]["cache_bytes"]
    # 36 layers x k and v x (128, 32768, 8, 128): bf16, or int8 and a
    # float32 scale a (position, kv head)
    per = 36 * 2 * 128 * 32768 * 8
    assert granite == per * (128 + 4 if kv_int8 else 128 * 2)
