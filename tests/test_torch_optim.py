"""The port's optimizers, schedules and proximal wrapper against the
reference's, on the CPU.

The same numpy params and five steps of numpy gradients go through
`repro.optim` (jitted) and `repro_torch.optim`.  Tolerances: the schedules
to 1e-6 relative (numpy's and XLA's float32 cos round apart by an ulp);
float32 params, masters and moments to 1e-6 of their scale (the same
float32 formulas; XLA may fuse a multiply-add where torch does not); bf16
params bitwise (both round the float32 master once) and their masters as
float32; the proximal wrapper's leaves to 1e-5 of scale (an SVD in
another library).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.optim.optimizers import global_norm, tree_items  # noqa: E402

SHAPES = {"attn": {"wq": (8, 6), "bias": (6,)}, "embed": (10, 4),
          "stack": {"w_in": (3, 5, 7)}, "scale": (1, 9)}
STEPS = 5
RTOL = 1e-6


def _build(fn, shapes):
    return {k: _build(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _torch(tree, dtype=torch.float32):
    return {k: _torch(v, dtype) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32)).to(dtype)
            for k, v in tree.items()}


def _flat(tree) -> dict:
    """A JAX pytree's leaves as float32 numpy, keyed by '.'-joined path."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf, np.float32) for path, leaf in leaves}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    params = _build(lambda s: rng.standard_normal(s).astype(np.float32),
                    SHAPES)
    grads = [_build(lambda s: 3 * rng.standard_normal(s).astype(np.float32),
                    SHAPES) for _ in range(STEPS)]
    return params, grads


def _close(got: dict, want: dict, rtol: float):
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= rtol, (k, err)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.1,)), ("linear_warmup", (1e-3, 7)),
    ("cosine_warmup", (3e-4, 50, 1000)), ("cosine_warmup", (1.0, 1, 4))])
def test_schedules_match(name, args):
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for step in range(0, 1200, 7):
        got, want = tf(step), np.float32(jf(jnp.int32(step)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_five_steps_match(name, dtype):
    params, grads = _data()
    sched = (jopt.cosine_warmup(1e-2, 2, 10), topt.cosine_warmup(1e-2, 2, 10))
    jo, to = jopt.make_optimizer(name, sched[0]), \
        topt.make_optimizer(name, sched[1])
    tdt = getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)
    tp = _torch(params, tdt)
    js, ts = jo.init(jp), to.init(tp)
    upd = jax.jit(jo.update)
    for i, g in enumerate(grads):
        jp, js = upd(jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), g),
                     js, jp, jnp.int32(i))
        tp2, ts2 = to.update(_torch(g, tdt), ts, tp, i)
        assert tp2 is tp and ts2 is ts            # updated in place
    assert all(leaf.dtype == tdt for _, leaf in tree_items(tp))
    jflat = _flat(jp)
    tflat = {".".join(p): v.float().numpy() for p, v in tree_items(tp)}
    if dtype == "bfloat16":
        for k in jflat:             # one rounding of the float32 master
            assert np.array_equal(tflat[k], jflat[k]), k
    else:
        _close(tflat, jflat, RTOL)
    jst = {k: v for k, v in _flat(js).items()}
    tst = {".".join(p): v.numpy() for p, v in tree_items(ts)}
    _close(tst, jst, RTOL)


def test_bf16_params_keep_an_fp32_master():
    params, grads = _data(1)
    to = topt.make_optimizer("adamw", topt.constant(1e-3))
    tp = _torch(params, torch.bfloat16)
    ts = to.init(tp)
    for _, m in tree_items(ts["master"]):
        assert m.dtype == torch.float32
    to.update(_torch(grads[0], torch.bfloat16), ts, tp, 0)
    for path, m in tree_items(ts["master"]):
        leaf = tp
        for k in path:
            leaf = leaf[k]
        assert torch.equal(leaf, m.to(torch.bfloat16))
        # the master keeps what bf16 cannot hold
        assert not torch.equal(m, leaf.float())


def test_global_norm_matches():
    params, _ = _data(2)
    want = float(jopt.optimizers.global_norm(
        jax.tree.map(jnp.asarray, params)))
    np.testing.assert_allclose(float(global_norm(_torch(params))), want,
                               rtol=1e-6)


@pytest.mark.parametrize("reg", ["nuclear", "l21"])
def test_proximal_wrap_matches(reg):
    params, grads = _data(3)

    def select(path):
        return path[-1] in ("wq", "w_in", "embed")

    jo = jopt.proximal_wrap(jopt.make_optimizer(
        "adamw", jopt.cosine_warmup(1e-2, 2, 10)), reg, 0.5, select)
    to = topt.proximal_wrap(topt.make_optimizer(
        "adamw", topt.cosine_warmup(1e-2, 2, 10)), reg, 0.5, select)
    assert to.name == jo.name == "prox_adamw"
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for i, g in enumerate(grads):
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.int32(i))
        tp, ts = to.update(_torch(g), ts, tp, i)
    tflat = {".".join(p): v.numpy() for p, v in tree_items(tp)}
    _close(tflat, _flat(jp), 1e-5)
    tm = {".".join(p): v.numpy() for p, v in tree_items(ts["master"])}
    _close(tm, _flat(js["master"]), 1e-5)
    # the selected leaves' masters are the projected params
    for k in ("attn.wq", "stack.w_in", "embed"):
        np.testing.assert_array_equal(tm[k], tflat[k])
