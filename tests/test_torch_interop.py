"""Engine state carried between the reference and the port as numpy leaves.

A JAX state goes to numpy, into the port (`state_from_numpy`), and the
port's `run` must continue the reference's event stream: host fields
bitwise, tensors to ENGINE_RTOL of their scale (float32 matrix products
summed in another order).  The reverse direction (`state_to_numpy`, then
`tree_unflatten` on the reference's treedef) must hold too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import amtl as jamtl  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.interop import (LEAVES, state_from_numpy,  # noqa: E402
                                 state_to_numpy)

ENGINE_RTOL = 1e-4
HOST = ("task_ring", "ptr", "event", "history.buf", "history.count", "key")


def _match(jax_state, port_state):
    a = dict(zip(LEAVES, (np.asarray(x) for x in
                          jax.tree_util.tree_leaves(jax_state))))
    b = dict(zip(LEAVES, state_to_numpy(port_state)))
    for f in LEAVES:
        assert a[f].shape == b[f].shape and a[f].dtype == b[f].dtype, f
        if f in HOST:
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
        else:
            scale = max(np.abs(a[f]).max(initial=0.0), 1e-30)
            assert np.abs(b[f] - a[f]).max(initial=0.0) \
                <= ENGINE_RTOL * scale, f


@pytest.fixture(scope="module")
def setup(small_problem):
    jp = small_problem
    tp = rt.problem_from_numpy(np.asarray(jp.xs), np.asarray(jp.ys), "lstsq",
                               "nuclear", 0.1, device="cpu")
    return jp, tp


@pytest.mark.parametrize("kind,kw", [
    ("delta", dict(prox_every=4, prox_rank=3)),
    ("batch", dict(event_batch=5, prox_every=10, dynamic_step=True)),
])
def test_jax_state_continues_in_port(setup, kind, kw):
    jp, tp = setup
    kw = dict(eta=1.0 / jp.lipschitz(), eta_k=0.7, tau=3, engine=kind, **kw)
    je = jamtl.make_engine(jp, jamtl.AMTLConfig(**kw))
    te = rt.make_engine(tp, rt.AMTLConfig(**kw), device="cpu")
    offs = np.array([2.0, 0.0, 1.0, 3.0, 1.0], np.float32)
    v0 = jnp.zeros((jp.dim, jp.num_tasks), jnp.float32)
    mid = je.run(je.init(v0, jax.random.PRNGKey(21)), jnp.asarray(offs), 30)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(mid)]
    port_mid = state_from_numpy(kind, leaves, device="cpu")
    _match(mid, port_mid)
    _match(je.run(mid, jnp.asarray(offs), 40), te.run(port_mid, offs, 40))


@pytest.mark.parametrize("kind,kw", [
    ("delta", dict(prox_every=1)),
    ("batch", dict(event_batch=5, prox_every=5, prox_rank=3)),
])
def test_port_state_continues_in_jax(setup, kind, kw):
    jp, tp = setup
    kw = dict(eta=1.0 / jp.lipschitz(), eta_k=0.7, tau=3, engine=kind, **kw)
    je = jamtl.make_engine(jp, jamtl.AMTLConfig(**kw))
    te = rt.make_engine(tp, rt.AMTLConfig(**kw), device="cpu")
    v0 = np.zeros((jp.dim, jp.num_tasks), np.float32)
    key = jax.random.PRNGKey(5)
    port_mid = te.run(te.init(v0, np.asarray(key)), None, 20)
    treedef = jax.tree_util.tree_structure(je.init(jnp.asarray(v0), key))
    jax_mid = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in state_to_numpy(port_mid)])
    _match(jax_mid, port_mid)
    _match(je.run(jax_mid, None, 30), te.run(port_mid, None, 30))


def test_state_from_numpy_validates():
    with pytest.raises(ValueError):
        state_from_numpy("dense", [np.zeros(1)] * len(LEAVES), device="cpu")
    with pytest.raises(ValueError):
        state_from_numpy("delta", [np.zeros(1)] * 3, device="cpu")


def test_problem_from_numpy_copies_exact_values():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((3, 4, 5)).astype(np.float32)
    ys = rng.standard_normal((3, 4)).astype(np.float32)
    p = rt.problem_from_numpy(xs, ys, "logistic", "l21", 0.3, device="cpu")
    np.testing.assert_array_equal(p.xs.numpy(), xs)
    np.testing.assert_array_equal(p.ys.numpy(), ys)
    assert (p.loss_name, p.reg_name, p.lam, p.num_tasks, p.dim) == \
        ("logistic", "l21", 0.3, 3, 5)
