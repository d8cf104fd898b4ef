"""The MoE FFN in the port (`models/moe.py`: `_router`, the routed
`moe_dense`, `moe_apply`) against the reference's (`_router` and the
dropless `moe_dense`, which runs every expert on every token), on the
CPU, at the reduced widths of dbrx-132b (d_model 256, 4 experts top-2,
d_expert 128, SwiGLU) and deepseek-v3-671b (the same with one shared
expert).  The reference's weights cross as numpy, the tokens come from
numpy, and the reference runs jitted.

Tolerances: in float32 the output to 1e-5 of its scale (the port sums an
expert's rows and the k slots in other orders than XLA's broadcast), the
router's weights to 1e-6 of scale, its expert ids exactly, and the aux
loss to 1e-6 relative.  In bfloat16 both round every product to bf16 in
their own orders, 2^-8 of a value at most each, so the output is held to
2e-2 of its scale (seen: 5.1e-3 and 6.3e-3) with the same expert ids
(the router is a float32 product of the same bf16 inputs).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

RTOL = 1e-5
BF16_RTOL = 2e-2
ARCHS = ("dbrx-132b", "deepseek-v3-671b")   # without, with a shared expert


def to_port(tree):
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def host(t: torch.Tensor) -> np.ndarray:
    return t.detach().double().numpy()


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = host(got) if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def setup(arch: str, seed: int = 0, dtype: str = "float32"):
    rcfg = dataclasses.replace(ref_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    rp = ref_moe.init_moe(jax.random.PRNGKey(seed), rcfg, jnp.dtype(dtype))
    return rcfg, cfg, rp, to_port(rp)


def tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def test_init_has_the_reference_leaves():
    """The leaves, shapes and dtypes of the reference's init: the router
    float32 in a bf16 model."""
    for arch in ARCHS:
        rcfg, cfg, rp, _ = setup(arch, dtype="bfloat16")
        p = moe.init_moe(cfg, torch.bfloat16, torch.Generator().manual_seed(0))
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in p.items()} == {
            k: (np.shape(v), "torch.float32" if k == "router"
                else "torch.bfloat16") for k, v in rp.items()}
        assert {k: tuple(v.shape) for k, v in p.items()} == \
            moe.param_shapes(cfg)


@pytest.mark.parametrize("n", [1, 7, 300])
def test_router_matches_reference(n):
    rcfg, cfg, rp, p = setup("deepseek-v3-671b", seed=n)
    x2 = tokens(cfg, 1, n, n)[0]
    w_r, i_r, a_r = jax.jit(lambda r, x: ref_moe._router(r, x, rcfg.moe))(
        rp["router"], x2)
    w, idx, aux = moe._router(p["router"], torch.from_numpy(x2), cfg.moe)
    assert idx.shape == (n, cfg.moe.top_k) and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_r))
    assert rel(w, w_r) <= 1e-6
    assert abs(aux.item() - float(a_r)) <= 1e-6 * abs(float(a_r))


def test_zero_router_picks_the_first_experts_as_top_k():
    """A zero router gives every expert the same probability: the top k
    are experts 0..k-1, in order, as `jax.lax.top_k` takes the lower index
    first among equals; weights 1/k and the aux loss E * k/E * 1/E * E."""
    rcfg, cfg, rp, p = setup("dbrx-132b")
    x2 = tokens(cfg, 1, 9, 1)[0]
    zero = np.zeros_like(np.asarray(rp["router"]))
    w_r, i_r, a_r = ref_moe._router(jnp.asarray(zero), x2, rcfg.moe)
    w, idx, aux = moe._router(torch.from_numpy(zero), torch.from_numpy(x2),
                              cfg.moe)
    k = cfg.moe.top_k
    np.testing.assert_array_equal(np.asarray(i_r), np.tile(np.arange(k),
                                                           (9, 1)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_r))
    np.testing.assert_array_equal(w.numpy(), np.full((9, k), 1.0 / k,
                                                     np.float32))
    assert aux.item() == pytest.approx(float(a_r), rel=1e-6)
    assert aux.item() == pytest.approx(float(k), rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS, ids=["routed", "routed+shared"])
@pytest.mark.parametrize("s", [1, 40])
def test_moe_dense_matches_reference(arch, s):
    rcfg, cfg, rp, p = setup(arch, seed=s)
    x = tokens(cfg, 2, s, s + 1)
    y_r, a_r = jax.jit(lambda p_, x_: ref_moe.moe_dense(p_, x_, rcfg))(rp, x)
    y, aux = moe.moe_dense(p, torch.from_numpy(x), cfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert rel(y, y_r) <= RTOL
    assert abs(aux.item() - float(a_r)) <= 1e-6 * abs(float(a_r))
    y2, _ = moe.moe_apply(p, torch.from_numpy(x), cfg)
    assert torch.equal(y, y2)


def test_an_expert_with_no_token():
    """Expert 2's router column pushed far down: no token picks it, the
    routed loop skips it, and the output and aux still match."""
    rcfg, cfg, rp, p = setup("deepseek-v3-671b", seed=5)
    x = np.abs(tokens(cfg, 2, 30, 5))
    router = np.array(rp["router"])
    router[:, 2] = -1.0
    rp = dict(rp, router=jnp.asarray(router))
    p = dict(p, router=torch.from_numpy(router))
    _, idx, _ = moe._router(p["router"], torch.from_numpy(x[0]), cfg.moe)
    assert not bool((idx == 2).any())
    y_r, a_r = ref_moe.moe_dense(rp, x, rcfg)
    y, aux = moe.moe_dense(p, torch.from_numpy(x), cfg)
    assert rel(y, y_r) <= RTOL
    assert abs(aux.item() - float(a_r)) <= 1e-6 * abs(float(a_r))


@pytest.mark.parametrize("arch", ARCHS, ids=["routed", "routed+shared"])
def test_bfloat16_moe_matches_reference(arch):
    rcfg, cfg, rp, p = setup(arch, seed=3, dtype="bfloat16")
    x = tokens(cfg, 2, 24, 3)
    xb = jnp.asarray(x, jnp.bfloat16)
    y_r, a_r = jax.jit(lambda p_, x_: ref_moe.moe_dense(p_, x_, rcfg))(rp,
                                                                      xb)
    _, i_r, _ = ref_moe._router(rp["router"], xb.reshape(-1, cfg.d_model),
                                rcfg.moe)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    _, idx, _ = moe._router(p["router"], xt.reshape(-1, cfg.d_model),
                            cfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_r))
    y, aux = moe.moe_dense(p, xt, cfg)
    assert y.dtype == torch.bfloat16
    assert rel(y, np.asarray(y_r, np.float32)) <= BF16_RTOL
    assert abs(aux.item() - float(a_r)) <= 1e-6 * abs(float(a_r))


def test_routed_experts_repeat_bitwise_and_keep_slot_order():
    """Two calls give the same bits, and a token whose k slots name the
    same expert rows in another slot order gets its weights in that
    order (each pair's output lands at its own (token, slot))."""
    _, cfg, _, p = setup("dbrx-132b", seed=2)
    g = torch.Generator().manual_seed(0)
    x2 = torch.randn(50, cfg.d_model, generator=g)
    w, idx, _ = moe._router(p["router"], x2, cfg.moe)
    a = moe.routed_experts(p, x2, w, idx, cfg.activation)
    assert torch.equal(a, moe.routed_experts(p, x2, w, idx, cfg.activation))
    b = moe.routed_experts(p, x2, w.flip(1), idx.flip(1), cfg.activation)
    assert rel(b, host(a)) <= 1e-6


def test_moe_apply_refuses_a_mesh():
    _, cfg, _, p = setup("dbrx-132b")
    x = torch.zeros(1, 2, cfg.d_model)
    with pytest.raises(NotImplementedError, match=r"11\(i\)"):
        moe.moe_apply(p, x, cfg, mesh=object())
