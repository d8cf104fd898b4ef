"""The engines' one-launch state updates on the CPU: `ops.amtl_event_inplace`
(the delta engine's column event on V and its undo ring) and
`ops.km_update_slot` (the dense engine's event on its ring) against the
reference's jitted steps, on the same numpy-seeded inputs.

Bitwise, in place.  The reference runs as the engines run it: jitted (op-by-op
JAX rounds each operation on its own and forms no fmas), once through its
plain oracle and once through its Pallas kernel in interpret mode, each
followed by the update-slice and the ring write in the same jitted function
(`src/repro/core/amtl.py:428-434` and `:488-496`).  Every other column of V
and every other ring slot stays bitwise untouched.  A bad argument raises
`ValueError` before anything is written, and no launch is counted.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import operators as joperators  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.kernels import amtl_event as k_event  # noqa: E402
from repro_torch.kernels import km_update as k_km  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ETA = 0.05
# (d, T, depth, t, eta_k): the first and last column; T odd; d not a
# multiple of 4; a ring of one slot (tau 0: src == dst); eta_k 0
CASES = [(64, 8, 3, 0, 0.37), (64, 8, 3, 7, 0.37), (33, 5, 4, 2, 0.37),
         (1000, 6, 2, 5, 0.37), (40, 6, 1, 3, 0.37), (64, 8, 3, 4, 0.0)]
IDS = [f"d{d}-T{t_}-depth{dp}-t{t}-etak{ek}" for d, t_, dp, t, ek in CASES]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _inputs(d, num_t, depth, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((d, num_t)).astype(np.float32)
    p, g = (rng.standard_normal(d).astype(np.float32) for _ in range(2))
    ring = rng.standard_normal((depth, d)).astype(np.float32)
    dense = rng.standard_normal((depth, d, num_t)).astype(np.float32)
    return v, p, g, ring, dense


@functools.partial(jax.jit, static_argnames=("pallas",))
def _jax_event(v, t, p, g, eta, eta_k, ring, slot, pallas):
    """The reference's delta step: the column event, then the column and
    the undo entry written back."""
    if pallas:
        v_new, old = jops.amtl_event(v[:, t], p, g, eta, eta_k,
                                     interpret=True)
    else:
        v_new, old = jref.amtl_event_ref(v[:, t], p, g, eta, eta_k)
    return v.at[:, t].set(v_new), ring.at[slot].set(old)


@functools.partial(jax.jit, static_argnames=("pallas",))
def _jax_slot(ring, src, dst, t, p, g, eta, eta_k, pallas):
    """The reference's dense step: the column update of the newest slot,
    then the new iterate written into the next slot."""
    v_cur = ring[src]
    if pallas:
        col = jops.km_update(v_cur[:, t][:, None], p[:, None], g[:, None],
                             eta, eta_k, interpret=True)[:, 0]
    else:
        col = joperators.km_block_update(v_cur[:, t], p, g, eta, eta_k)
    return ring.at[dst].set(v_cur.at[:, t].set(col))


@pytest.mark.parametrize("pallas", [False, True], ids=["oracle", "pallas"])
@pytest.mark.parametrize("d,num_t,depth,t,eta_k", CASES, ids=IDS)
def test_amtl_event_inplace_bitwise_the_jitted_step(d, num_t, depth, t,
                                                    eta_k, pallas):
    v, p, g, ring, _ = _inputs(d, num_t, depth, d + 7 * num_t + t)
    slot = (t + 1) % depth
    want_v, want_ring = _jax_event(v, t, p, g, jnp.float32(ETA),
                                   jnp.float32(eta_k), ring, slot,
                                   pallas=pallas)
    tv, tring = torch.from_numpy(v.copy()), torch.from_numpy(ring.copy())
    ops.reset_launch_counts()
    assert ops.amtl_event_inplace(tv, t, torch.from_numpy(p),
                                  torch.from_numpy(g), ETA, eta_k, tring,
                                  slot) is None
    assert ops.launch_counts()["amtl_event"] == 0       # CPU: plain version
    np.testing.assert_array_equal(_bits(tv), _bits(want_v))
    np.testing.assert_array_equal(_bits(tring), _bits(want_ring))
    others = [c for c in range(num_t) if c != t]
    np.testing.assert_array_equal(_bits(tv[:, others]), _bits(v[:, others]))
    np.testing.assert_array_equal(_bits(tring[slot]), _bits(v[:, t]))
    rest = [s for s in range(depth) if s != slot]
    np.testing.assert_array_equal(_bits(tring[rest]), _bits(ring[rest]))


@pytest.mark.parametrize("pallas", [False, True], ids=["oracle", "pallas"])
@pytest.mark.parametrize("d,num_t,depth,t,eta_k", CASES, ids=IDS)
def test_km_update_slot_bitwise_the_jitted_step(d, num_t, depth, t, eta_k,
                                                pallas):
    _, p, g, _, dense = _inputs(d, num_t, depth, 3 * d + num_t + t)
    dst = (t + 2) % depth
    src = (dst - 1) % depth
    want = _jax_slot(dense, src, dst, t, p, g, jnp.float32(ETA),
                     jnp.float32(eta_k), pallas=pallas)
    tring = torch.from_numpy(dense.copy())
    ops.reset_launch_counts()
    assert ops.km_update_slot(tring, src, dst, t, torch.from_numpy(p),
                              torch.from_numpy(g), ETA, eta_k) is None
    assert ops.launch_counts()["km_update"] == 0
    np.testing.assert_array_equal(_bits(tring), _bits(want))
    others = [c for c in range(num_t) if c != t]
    np.testing.assert_array_equal(_bits(tring[dst][:, others]),
                                  _bits(dense[src][:, others]))
    rest = [s for s in range(depth) if s != dst]
    np.testing.assert_array_equal(_bits(tring[rest]), _bits(dense[rest]))
    if depth == 1:                           # tau 0: the slot in place
        assert src == dst


def _bad_event_args():
    """(label, overrides) of calls `amtl_event_inplace` must refuse."""
    v = torch.zeros(16, 5)
    return [
        ("t negative", dict(t=-1)), ("t = T", dict(t=5)),
        ("t not an int", dict(t=1.0)),
        ("slot negative", dict(slot=-1)), ("slot = depth", dict(slot=3)),
        ("v float64", dict(v=v.double())),
        ("v not contiguous", dict(v=torch.zeros(5, 16).T)),
        ("v 1-d", dict(v=torch.zeros(16))),
        ("p_t short", dict(p_t=torch.zeros(15))),
        ("g_t bf16", dict(g_t=torch.zeros(16, dtype=torch.bfloat16))),
        ("ring of another d", dict(ring=torch.zeros(3, 15))),
        ("ring not contiguous", dict(ring=torch.zeros(16, 3).T)),
        ("ring float64", dict(ring=torch.zeros(3, 16, dtype=torch.float64))),
    ]


def _bad_slot_args():
    return [
        ("t negative", dict(t=-1)), ("t = T", dict(t=5)),
        ("src = depth", dict(src=3)), ("dst negative", dict(dst=-1)),
        ("ring float64", dict(ring=torch.zeros(3, 16, 5,
                                               dtype=torch.float64))),
        ("ring not contiguous", dict(ring=torch.zeros(3, 5, 16)
                                     .transpose(1, 2))),
        ("ring 2-d", dict(ring=torch.zeros(16, 5))),
        ("p_t short", dict(p_t=torch.zeros(15))),
        ("g_t not contiguous", dict(g_t=torch.zeros(16, 2)[:, 0])),
    ]


@pytest.mark.parametrize("label,bad", _bad_event_args(),
                         ids=[a[0] for a in _bad_event_args()])
def test_amtl_event_inplace_refuses_bad_arguments(label, bad):
    args = dict(v=torch.randn(16, 5), t=2, p_t=torch.randn(16),
                g_t=torch.randn(16), eta=ETA, eta_k=0.5,
                ring=torch.randn(3, 16), slot=1)
    args.update(bad)
    before = {k: a.clone() for k, a in args.items()
              if isinstance(a, torch.Tensor)}
    ops.reset_launch_counts()
    with pytest.raises(ValueError):
        ops.amtl_event_inplace(**args)
    with pytest.raises(ValueError):                 # the kernel's wrapper
        k_event.amtl_event_inplace(**args)
    for k, a in before.items():
        assert torch.equal(args[k], a), f"{label}: {k} was written"
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("label,bad", _bad_slot_args(),
                         ids=[a[0] for a in _bad_slot_args()])
def test_km_update_slot_refuses_bad_arguments(label, bad):
    args = dict(ring=torch.randn(3, 16, 5), src=0, dst=1, t=2,
                p_t=torch.randn(16), g_t=torch.randn(16), eta=ETA,
                eta_k=0.5)
    args.update(bad)
    before = {k: a.clone() for k, a in args.items()
              if isinstance(a, torch.Tensor)}
    ops.reset_launch_counts()
    with pytest.raises(ValueError):
        ops.km_update_slot(**args)
    with pytest.raises(ValueError):
        k_km.km_update_slot(**args)
    for k, a in before.items():
        assert torch.equal(args[k], a), f"{label}: {k} was written"
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_kernel_wrappers_take_only_cuda_tensors():
    """Good arguments on the CPU: the kernel wrappers refuse them (no path
    from a wrapper to the plain version), ops takes the plain version."""
    v, ring = torch.randn(16, 5), torch.randn(3, 16)
    col = torch.randn(16)
    with pytest.raises(ValueError, match="CUDA"):
        k_event.amtl_event_inplace(v, 2, col, col, ETA, 0.5, ring, 1)
    with pytest.raises(ValueError, match="CUDA"):
        k_km.km_update_slot(torch.randn(3, 16, 5), 0, 1, 2, col, col, ETA,
                            0.5)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.amtl_event_inplace(v.to("meta"), 2, col.to("meta"),
                               col.to("meta"), ETA, 0.5, ring.to("meta"), 1)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def _problem(reg_name="l21"):
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((5, 12, 20)).astype(np.float32)
    ys = rng.standard_normal((5, 12)).astype(np.float32)
    return rt.problem_from_numpy(xs, ys, "lstsq", reg_name, 0.3,
                                 device="cpu")


@pytest.mark.parametrize("engine,tau,calls,gone", [
    ("delta", 3, "amtl_event_inplace", ("amtl_event", "amtl_event_batch")),
    ("delta", 0, "amtl_event_inplace", ("amtl_event", "amtl_event_batch")),
    ("dense", 3, "km_update_slot", ("km_update",)),
    ("dense", 0, "km_update_slot", ("km_update",)),
])
def test_engines_make_one_state_update_an_event(monkeypatch, engine, tau,
                                                calls, gone):
    """Each event of the delta and dense engines makes exactly one call to
    its state update, and none to the contiguous forms."""
    seen = {name: 0 for name in (calls, *gone)}

    def counting(name):
        inner = getattr(ops, name)

        def call(*a, **k):
            seen[name] += 1
            return inner(*a, **k)
        return call

    for name in seen:
        monkeypatch.setattr(ops, name, counting(name))
    problem = _problem()
    cfg = rt.AMTLConfig(eta=0.01, eta_k=0.5, tau=tau, engine=engine)
    eng = rt.make_engine(problem, cfg, device="cpu")
    state = eng.init(np.zeros((20, 5), np.float32),
                     np.array([0, 7], np.uint32))
    eng.run(state, np.array([1, 0, 2, 1, 0], np.float32), 9)
    assert seen == {calls: 9, **{name: 0 for name in gone}}


def _other_strides(x):
    """x's values with its last two axes column-major (not contiguous)."""
    if not isinstance(x, torch.Tensor) or x.dim() < 2:
        return x
    return x.transpose(-1, -2).contiguous().transpose(-1, -2)


@pytest.mark.parametrize("where", ["v0", "state"])
@pytest.mark.parametrize("engine", ["delta", "dense", "batch"])
def test_engines_take_state_of_any_strides(engine, where):
    """A Fortran-ordered v0, or a state whose tensors are column-major,
    runs bitwise as the row-major one: the engines make their state
    contiguous where they clone it, so the in-place kernels see no
    strides the reference does not have."""
    problem = _problem()
    cfg = rt.AMTLConfig(eta=0.01, eta_k=0.5, tau=3, engine=engine,
                        **(dict(event_batch=3, prox_every=3)
                           if engine == "batch" else {}))
    eng = rt.make_engine(problem, cfg, device="cpu")
    v0 = np.random.default_rng(5).standard_normal((20, 5)).astype(np.float32)
    key, offs = np.array([0, 7], np.uint32), np.array([1, 0, 2, 1, 0],
                                                      np.float32)
    want = eng.iterate(eng.run(eng.init(v0, key), offs, 9))
    if where == "v0":
        state = eng.init(np.asfortranarray(v0), key)
    else:
        state = eng.init(v0, key)
        state = state._replace(**{f: _other_strides(getattr(state, f))
                                  for f in state._fields})
        assert not all(getattr(state, f).is_contiguous()
                       for f in state._fields
                       if isinstance(getattr(state, f), torch.Tensor))
    got = eng.iterate(eng.run(state, offs, 9))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
