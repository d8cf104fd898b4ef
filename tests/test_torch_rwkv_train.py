"""rwkv6-3b training in the port against the reference's, on the CPU.

The WKV gradient's plain versions: `ref.wkv_bwd_ref` (autograd through
the chunked form) against `jax.grad` of the reference's `_wkv_chunked`,
and `ref.wkv_bwd_exact_ref` (the token-by-token formulas of
`csrc/rwkv6_bwd.cu`) against both, on numpy-seeded inputs in float32.
Tolerances: each gradient within 1e-5 of its max |value| (float32 sums in
other orders; seen at most 7e-7 at these decays).  At edge decays the
chunked form loses precision (log-space decays re-centred at half a
chunk), so there the exact formulas are held to a float64 autograd of the
recurrence instead, at 1e-5 of scale.  The identity that gives dlog w from
dr and dk (used nowhere in the port, which takes dw from S and dS
directly) is checked in float64 to 1e-12.

Then the model: reduced rwkv6-3b (1 layer, d_model 256, 8 heads of 32,
chunk 16, float32) takes `forward`'s loss and gradients to 1e-5 of scale
against `jax.value_and_grad` of the reference's, and three train steps'
losses to 1e-5 relative, as tests/test_torch_train.py holds gemma2-2b.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.rwkv import _wkv_chunked  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import synthetic_lm_batches  # noqa: E402
from repro_torch.interop import (lm_params_from_numpy,  # noqa: E402
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_bwd as k_bwd  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim.optimizers import tree_items  # noqa: E402

RTOL = 1e-5
NAMES = ("dr", "dk", "dv", "dw", "du")


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", k)))


def flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def wkv_case(seed, b, ell, h, d, w_lo, w_hi, dtype=np.float32):
    """r, k, v, do ~ 0.5 N; w uniform in [w_lo, w_hi]; u ~ 0.5 N."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (0.5 * rng.standard_normal((b, ell, h, d)) for _ in range(4))
    w = rng.uniform(w_lo, w_hi, (b, ell, h, d))
    u = 0.5 * rng.standard_normal((h, d))
    return tuple(x.astype(dtype) for x in (r, k, v, w, u, do))


def jax_grads(case, chunk):
    r, k, v, w, u, do = (jnp.asarray(x) for x in case)
    _, vjp = jax.vjp(lambda *a: _wkv_chunked(*a, chunk)[0], r, k, v, w, u)
    return [np.asarray(g) for g in vjp(do)]


def torch_case(case):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in case)


# (seed, B, L, H, D, w range, chunk): L off the chunk, D 32 and 64, decays
# in [0.5, 1] and near 1 (the model's init is w ~ 0.9975)
GRAD_CASES = [(1, 2, 37, 3, 32, (0.5, 1.0), 16),
              (2, 1, 70, 2, 64, (0.5, 1.0), 16),
              (3, 2, 50, 2, 32, (0.99, 1.0), 16),
              (4, 1, 200, 2, 64, (0.9, 1.0), 128)]


@pytest.mark.parametrize("seed,b,ell,h,d,wr,chunk", GRAD_CASES)
def test_wkv_bwd_ref_matches_jax_grad_of_wkv_chunked(seed, b, ell, h, d, wr,
                                                     chunk):
    case = wkv_case(seed, b, ell, h, d, *wr)
    want = jax_grads(case, chunk)
    got = ref.wkv_bwd_ref(*torch_case(case), chunk)
    for name, g, wnt in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == wnt.shape, name
        assert rel(g, wnt) <= RTOL, name


@pytest.mark.parametrize("seed,b,ell,h,d,wr,chunk", GRAD_CASES)
def test_exact_gradient_matches_both_chunked_gradients(seed, b, ell, h, d,
                                                       wr, chunk):
    case = wkv_case(seed, b, ell, h, d, *wr)
    exact = ref.wkv_bwd_exact_ref(*torch_case(case))
    chunked = ref.wkv_bwd_ref(*torch_case(case), chunk)
    for name, e, c, j in zip(NAMES, exact, chunked,
                             jax_grads(case, chunk)):
        assert rel(e, c) <= RTOL, name
        assert rel(e, j) <= RTOL, name


def recurrence64(r, k, v, w, u):
    """The recurrence in float64 autograd: the exact yardstick."""
    b, ell, h, d = r.shape
    s = torch.zeros((b, h, d, d), dtype=torch.float64)
    outs = []
    for t in range(ell):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhd,bhde->bhe", r[:, t],
                                 s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, 1)


def grads64(case):
    leaves = [torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
              for x in case[:5]]
    return torch.autograd.grad(recurrence64(*leaves), leaves,
                               torch.from_numpy(case[5].astype(np.float64)))


@pytest.mark.parametrize("log_w0", [1.9, 2.63, None],
                         ids=["w~1e-3", "w~1e-6", "w=1"])
def test_exact_gradient_holds_at_edge_decays(log_w0):
    """w = exp(-exp(log_w0 + 0.5 N)) as chip_smoke.py draws the edge
    decays (neighbours up to ~1e10 apart at w near 1e-6), or w = 1."""
    rng = np.random.default_rng(17)
    case = list(wkv_case(17, 1, 100, 2, 32, 0.5, 1.0))
    if log_w0 is None:
        case[3] = np.ones_like(case[3])
    else:
        case[3] = np.exp(-np.exp(log_w0 + 0.5 * rng.standard_normal(
            case[3].shape))).astype(np.float32)
    want = grads64(case)
    got = ref.wkv_bwd_exact_ref(*torch_case(case))
    for name, g, wnt in zip(NAMES, got, want):
        assert bool(torch.isfinite(g).all()), name
        assert rel(g, wnt) <= RTOL, name


def test_dlogw_and_du_identity_in_float64():
    """dlog w_i = sum_{t>i} r_t * dr'_t - sum_{j>=i} k_j * dk'_j (dr', dk'
    without the bonus term) and du = sum r * k (v . do)."""
    case = wkv_case(5, 2, 40, 2, 8, 0.3, 1.0, np.float64)
    r, k, v, w, u, do = torch_case(case)
    dr, dk, dv, dw, du = ref.wkv_bwd_exact_ref(r, k, v, w, u, do)
    assert dw.dtype == torch.float64
    vdo = (v * do).sum(-1, keepdim=True)
    drp = dr - u * k * vdo
    dkp = dk - u * r * vdo
    a = (r * drp).flip(1).cumsum(1).flip(1)            # sum over t >= i
    a = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)   # t > i
    bsum = (k * dkp).flip(1).cumsum(1).flip(1)         # sum over j >= i
    assert rel((a - bsum) / w, dw) <= 1e-12
    assert rel((r * k * vdo).sum((0, 1)), du) <= 1e-12
    for got, want in zip((dr, dk, dv, dw, du), grads64(case)):
        assert rel(got, want) <= 1e-12


def test_wkv_under_grad_is_an_autograd_node_with_the_chunked_gradient():
    case = torch_case(wkv_case(6, 2, 37, 2, 32, 0.5, 1.0))
    leaves = [t.clone().requires_grad_(True) for t in case[:5]]
    ops.reset_launch_counts()
    out = ops.wkv(*leaves, None, chunk=16)
    assert type(out.grad_fn).__name__ == "_WKVBackward"
    grads = torch.autograd.grad(out, leaves, case[5])
    for g, want in zip(grads, ref.wkv_bwd_ref(*case, 16)):
        assert torch.equal(g, want)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}  # CPU: plain
    want_out, _ = ref.wkv_chunked_ref(*case[:5], 16)
    assert torch.equal(out.detach(), want_out)


def test_wkv_under_grad_refuses_a_state():
    case = torch_case(wkv_case(7, 1, 8, 2, 32, 0.5, 1.0))
    r = case[0].clone().requires_grad_(True)
    state = torch.zeros(1, 2, 32, 32, requires_grad=True)
    with pytest.raises(ValueError, match="state"):
        ops.wkv(r, *case[1:5], state, chunk=16)
    with pytest.raises(ValueError, match="state"):
        ops.wkv(r, *case[1:5], state.detach(), chunk=16)
    with torch.no_grad():                 # without grad a state is updated
        s = torch.zeros(1, 2, 32, 32)
        ops.wkv(r, *case[1:5], s, chunk=16)
        assert bool(s.abs().sum() > 0)


def test_kernel_wrapper_refuses_cpu_tensors_and_unknown_routes():
    case = torch_case(wkv_case(8, 1, 8, 2, 32, 0.5, 1.0))
    with pytest.raises(ValueError, match="CUDA"):
        k_bwd.wkv_bwd(*case)
    with pytest.raises(ValueError, match="route"):
        k_bwd.wkv_bwd(*case, route="chunked")
    assert k_bwd.scratch_shapes(2, 2048, 40, 64) == {
        "ckpt": (80, 256, 64, 64), "du_part": (2, 40, 64)}
    assert k_bwd.scratch_shapes(1, 9, 1, 32)["ckpt"] == (1, 2, 32, 32)


def test_rwkv_training_is_ported():
    cfg = get_config("rwkv6-3b")
    transformer.require_ported(cfg, training=True)
    transformer.require_ported(cfg.reduced(), training=True)
    assert "rwkv" in transformer.TRAINED_KINDS


@pytest.fixture(scope="module")
def setup():
    rcfg = ref_config("rwkv6-3b").reduced()
    cfg = get_config("rwkv6-3b").reduced()
    params = jtf.init_params(jax.random.PRNGKey(0), rcfg)
    batch = next(synthetic_lm_batches(cfg.vocab_size, 40, 2,
                                      cfg.mtl.num_tasks, seed=1))
    return rcfg, cfg, params, batch


def test_forward_loss_and_grads_match(setup):
    """Sequence 40 (off the 16-token chunk), remat off, float32."""
    rcfg, cfg, params, batch = setup
    model = lm_params_from_numpy(cfg, flat(params), "cpu")
    model.requires_grad_(True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        loss, m = jtf.forward(p, jb, rcfg, remat=False)
        return loss + 0.1 * jnp.sum(m["pooled"] ** 2), (loss, m)

    (_, (jl, jm)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m = transformer.forward(model, tb, cfg, remat=False)
    (loss + 0.1 * torch.sum(m["pooled"] ** 2)).backward()
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl))
    assert rel(m["pooled"], jm["pooled"]) <= RTOL
    jflat = flat(jg)
    for path, leaf in tree_items(model.tree()):
        assert leaf.grad is not None, path
        assert rel(leaf.grad, jflat[".".join(path)]) <= RTOL, path
        if path[-1] in ("wr", "wk", "wv", "w0", "w_lora_a", "u"):
            assert float(leaf.grad.abs().max()) > 0, path


def test_three_train_steps_match(setup):
    rcfg, cfg, _, _ = setup
    lr = 1e-3
    jopt = jsteps.default_optimizer(rcfg, lr=lr, total_steps=10)
    popt = steps.default_optimizer(cfg, lr=lr, total_steps=10)
    js = jsteps.init_train_state(jax.random.PRNGKey(0), rcfg, jopt)
    ps = train_state_from_numpy(cfg, flat(js), popt, "cpu")
    jstep = jax.jit(jsteps.make_train_step(rcfg, jopt, remat=True))
    pstep = steps.make_train_step(cfg, popt, remat=True)
    it = synthetic_lm_batches(cfg.vocab_size, 32, 2, cfg.mtl.num_tasks,
                              seed=1)
    ops.reset_launch_counts()
    for i in range(3):
        b = next(it)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pstep(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "lm_loss", "probe_loss"):
            assert abs(float(pm[k]) - float(jm[k])) <= RTOL * abs(
                float(jm[k])), (i, k)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    want, got = flat(js), train_state_to_numpy(ps)
    for k, w in want.items():
        if k.startswith("params."):
            assert np.abs(got[k] - w).max() <= 2 * lr * 3, k
    assert rel(got["mtl.ring"], want["mtl.ring"]) <= RTOL


def test_train_driver_runs_rwkv_on_the_cpu():
    log = train.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "24",
                      "--log-every", "1"])
    assert [r["step"] for r in log] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in log)


def test_reduced_config_is_the_references():
    got = dataclasses.asdict(get_config("rwkv6-3b").reduced())
    want = dataclasses.asdict(ref_config("rwkv6-3b").reduced())
    assert got == want
