"""The port's Mamba-2 block (`repro_torch.models.ssm`) against the
reference's (`repro.models.ssm`), on the CPU in float32.

The chunked SSD is held at L 1, 2, 16, 40 and 64 with chunk 16 (one chunk
shorter than the chunk, one exactly, a padded tail, several chunks), from
zero and from a drawn state h0, with one group of heads and with two; the
causal conv at lengths shorter than and past its window; `mamba_forward`
with its state at prompts 2, 40 and 64 (a conv state left-padded when L <
3) on the reduced zamba2-7b config (d_model 256, 16 heads of 32, state
16); and decode steps after a prefill against the reference's decode and
against the port's own prefill of the longer prompt.  The reference's
init makes A_log 0, D 1, dt_bias 0 and conv_b 0, which would leave the
decay, the skip and the bias untested, so every test draws them from numpy
(A_log U(-1, 1), dt_bias U(-2, 0), D U(0.5, 1.5), conv_b 0.1 N) and gives
the same values to both packages.  Everything is held to 1e-5 of its scale
(the batched matmuls sum in another order than XLA's einsums).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

RTOL = 1e-5
CHUNK = 16


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t(a):
    return torch.as_tensor(np.array(a))


def ssd_inputs(ell: int, groups: int, seed: int, h: int = 4, p: int = 8,
               n: int = 16):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((2, ell, h, p)).astype(f32),
        dt=np.log1p(np.exp(rng.standard_normal((2, ell, h)) - 1.0)).astype(
            f32),
        a_log=rng.uniform(-1.0, 1.0, h).astype(f32),
        b_mat=rng.standard_normal((2, ell, groups, n)).astype(f32),
        c_mat=rng.standard_normal((2, ell, groups, n)).astype(f32),
        d_skip=rng.uniform(0.5, 1.5, h).astype(f32),
        h0=rng.standard_normal((2, h, p, n)).astype(f32))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("ell", [1, 2, 16, 40, 64])
def test_ssd_chunked_matches_reference(ell, with_h0, groups):
    a = ssd_inputs(ell, groups, seed=ell + 7 * groups)
    h0 = a.pop("h0")
    h0 = h0 if with_h0 else None
    want_y, want_h = jax.jit(
        lambda kw, h0: jssm._ssd_chunked(**kw, chunk=CHUNK, h0=h0))(
        {k: jnp.asarray(v) for k, v in a.items()},
        None if h0 is None else jnp.asarray(h0))
    got_y, got_h = ssm._ssd_chunked(**{k: t(v) for k, v in a.items()},
                                    chunk=CHUNK,
                                    h0=None if h0 is None else t(h0))
    assert got_y.shape == (2, ell, 4, 8) and got_y.dtype == torch.float32
    assert got_h.shape == (2, 4, 8, 16) and got_h.dtype == torch.float32
    assert rel(got_y, want_y) <= RTOL
    assert rel(got_h, want_h) <= RTOL


def test_ssd_chunked_does_not_form_the_six_dim_tensor():
    """No intermediate of the SSD holds more elements than the largest
    (B, nc, H, Q, Q) factor: the reference's three-operand einsums are
    pairwise steps here."""
    a = {k: t(v) for k, v in ssd_inputs(64, 1, seed=3, h=4, p=8).items()}
    biggest = []

    class Watch(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                biggest.append(out.numel())
            return out

    with Watch():
        ssm._ssd_chunked(a["x"], a["dt"], a["a_log"], a["b_mat"],
                         a["c_mat"], a["d_skip"], chunk=CHUNK)
    b, nc, h, q, p = 2, 64 // CHUNK, 4, CHUNK, 8
    assert max(biggest) == b * nc * h * q * q
    assert max(biggest) < b * nc * q * q * h * p


@pytest.mark.parametrize("ell", [1, 2, 40])
def test_causal_conv_matches_reference(ell):
    rng = np.random.default_rng(ell)
    xbc = rng.standard_normal((2, ell, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32) / 4
    b = rng.standard_normal(24).astype(np.float32) * 0.1
    want = jax.jit(jssm._causal_conv)(jnp.asarray(xbc), jnp.asarray(w),
                                      jnp.asarray(b))
    got = ssm._causal_conv(t(xbc), t(w), t(b))
    assert rel(got, want) <= RTOL


def configs():
    return ref_config("zamba2-7b").reduced(), get_config("zamba2-7b").reduced()


def perturbed_mamba(rcfg, seed: int) -> dict:
    """The reference's init_mamba leaves with the constants drawn."""
    p = {k: np.asarray(v) if not isinstance(v, dict) else
         {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in jssm.init_mamba(jax.random.PRNGKey(seed), rcfg,
                                     jnp.float32).items()}
    rng = np.random.default_rng(seed)
    h = p["A_log"].shape[0]
    p["A_log"] = rng.uniform(-1.0, 1.0, h).astype(np.float32)
    p["dt_bias"] = rng.uniform(-2.0, 0.0, h).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)).astype(
        np.float32)
    return p


def to_jax(p: dict):
    return jax.tree_util.tree_map(jnp.asarray, p)


def to_torch(p: dict):
    return {k: to_torch(v) if isinstance(v, dict) else t(v)
            for k, v in p.items()}


def test_init_mamba_matches_the_reference_layout():
    """The same leaves, shapes and dtypes as the reference's init (bf16
    with A_log, D and dt_bias float32), and its constants."""
    rcfg, cfg = configs()
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        jssm.init_mamba(jax.random.PRNGKey(0), rcfg, jnp.bfloat16))
    want = {".".join(str(k.key) for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in leaves}
    got = ssm.init_mamba(cfg, torch.bfloat16,
                         torch.Generator().manual_seed(0))
    got = {**{k: v for k, v in got.items() if k != "norm"},
           "norm.scale": got["norm"]["scale"]}
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == want
    assert {k: v[0] for k, v in want.items()} == ssm.param_shapes(cfg)
    assert torch.equal(got["A_log"], torch.zeros(16))
    assert torch.equal(got["dt_bias"], torch.zeros(16))
    assert torch.equal(got["D"], torch.ones(16))


@pytest.mark.parametrize("ell", [2, 40, 64])
def test_mamba_forward_with_state_matches_reference(ell):
    rcfg, cfg = configs()
    p = perturbed_mamba(rcfg, seed=ell)
    x = np.random.default_rng(ell + 1).standard_normal(
        (2, ell, cfg.d_model)).astype(np.float32)
    want, wstate = jax.jit(lambda p, x: jssm.mamba_forward(
        p, x, rcfg, return_state=True))(to_jax(p), jnp.asarray(x))
    got, state = ssm.mamba_forward(to_torch(p), t(x), cfg,
                                   return_state=True)
    assert rel(got, want) <= RTOL
    assert state.conv.shape == (2, 3, ssm._dims(cfg)[2])
    assert rel(state.conv, wstate.conv) <= RTOL
    assert state.ssm.dtype == torch.float32
    assert rel(state.ssm, wstate.ssm) <= RTOL
    if ell < 3:     # the conv state is left-padded with zeros
        assert not bool(state.conv[:, :3 - ell].any())
    assert torch.equal(ssm.mamba_forward(to_torch(p), t(x), cfg), got)


@pytest.mark.parametrize("ell", [2, 40, 64])
def test_mamba_decode_continues_the_prefill(ell):
    """Four decode steps after a prefill of L tokens: against the
    reference's decode from the reference's state, and against the port's
    prefill of the L + 4 tokens (its last four positions)."""
    rcfg, cfg = configs()
    p = perturbed_mamba(rcfg, seed=100 + ell)
    steps = 4
    x = np.random.default_rng(ell).standard_normal(
        (2, ell + steps, cfg.d_model)).astype(np.float32)
    tp = to_torch(p)
    _, state = ssm.mamba_forward(tp, t(x[:, :ell]), cfg, return_state=True)
    _, wstate = jssm.mamba_forward(to_jax(p), jnp.asarray(x[:, :ell]), rcfg,
                                   return_state=True)
    jdecode = jax.jit(lambda p, x, s: jssm.mamba_decode(p, x, s, rcfg))
    full = ssm.mamba_forward(tp, t(x), cfg)
    for i in range(steps):
        xi = x[:, ell + i:ell + i + 1]
        want, wstate = jdecode(to_jax(p), jnp.asarray(xi), wstate)
        got, state = ssm.mamba_decode(tp, t(xi), state, cfg)
        assert got.shape == (2, 1, cfg.d_model)
        assert rel(got, want) <= RTOL, f"step {i}"
        assert rel(state.conv, wstate.conv) <= RTOL
        assert rel(state.ssm, wstate.ssm) <= RTOL
        assert rel(got, full[:, ell + i:ell + i + 1]) <= RTOL, f"step {i}"


def test_ssd_of_a_split_sequence_equals_the_whole():
    """The SSD of the first 40 tokens, continued from its final state over
    the next 24, gives the SSD of all 64: the state carries everything."""
    a = {k: t(v) for k, v in ssd_inputs(64, 1, seed=11).items()}
    a.pop("h0")
    whole, h_whole = ssm._ssd_chunked(**a, chunk=CHUNK)

    def part(sl):
        return {k: (v[:, sl] if k in ("x", "dt", "b_mat", "c_mat") else v)
                for k, v in a.items()}

    y1, h1 = ssm._ssd_chunked(**part(slice(0, 40)), chunk=CHUNK)
    y2, h2 = ssm._ssd_chunked(**part(slice(40, 64)), chunk=CHUNK, h0=h1)
    assert rel(torch.cat([y1, y2], 1), whole) <= RTOL
    assert rel(h2, h_whole) <= RTOL


def test_reduced_ssm_config_is_the_references():
    rcfg, cfg = configs()
    assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(rcfg.ssm)
    assert ssm._dims(cfg) == jssm._dims(rcfg)
