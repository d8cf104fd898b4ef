"""DeepSeek's MLA in the port (`models/attention.py`: `init_mla`,
`mla_forward`, `_fit2`, `_mha_mixed_dims`, `mla_decode`) against the
reference's, on the CPU, in float32, at deepseek-v3-671b's reduced MLA
widths (d_model 256, 4 heads, q_lora 64, kv_lora 32, nope 32, rope 16, v
32: q and k at 48 columns, v zero-padded from 32).  The reference's
weights cross as numpy, the inputs come from numpy, and the reference
runs jitted.  Outputs and cache leaves are held to 1e-5 of their scale
(matmuls summed in another order than XLA's); the cache's rows that both
leave zero must be exactly zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402

RTOL = 1e-5
ARCH = "deepseek-v3-671b"


def to_port(tree):
    """A reference param dict as the port's: nested dicts of CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def setup(seed: int = 0):
    rcfg, cfg = ref_config(ARCH).reduced(), get_config(ARCH).reduced()
    rp = ref_attn.init_mla(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    return rcfg, cfg, rp, to_port(rp)


def inputs(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def test_init_has_the_reference_leaves():
    rcfg, cfg, rp, _ = setup()
    gen = torch.Generator().manual_seed(0)
    p = attention.init_mla(cfg, torch.float32, gen)
    want = {k: np.shape(v) for k, v in _flat(rp).items()}
    assert {k: tuple(v.shape) for k, v in _flat(p).items()} == want
    assert want == attention.mla_shapes(cfg)
    assert bool((p["q_norm"]["scale"] == 1).all())


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


@pytest.mark.parametrize("s,cache_len", [(40, 48), (40, 40), (40, 24)],
                         ids=["s<cl", "s=cl", "s>cl"])
def test_mla_forward_and_cache_match_reference(s, cache_len):
    """The prefill's output and the MLACache leaves at a cache longer than
    the prompt (zero-padded), as long, and shorter (its last positions)."""
    rcfg, cfg, rp, p = setup()
    x = inputs(cfg, 2, s, s + cache_len)
    want, rcache = jax.jit(lambda p_, x_: ref_attn.mla_forward(
        p_, x_, rcfg, return_cache=True, cache_len=cache_len))(rp, x)
    ops.reset_launch_counts()
    got, cache = attention.mla_forward(p, torch.from_numpy(x), cfg,
                                       return_cache=True,
                                       cache_len=cache_len)
    assert ops.launch_counts()["flash_attention"] == 0   # CPU: plain only
    assert got.shape == (2, s, cfg.d_model)
    assert rel(got, want) <= RTOL
    for name in ("c_kv", "k_rope"):
        g, w = getattr(cache, name), np.asarray(getattr(rcache, name))
        assert tuple(g.shape) == w.shape == (2, cache_len,) + w.shape[2:]
        assert rel(g, w) <= RTOL, name
        if cache_len > s:
            assert not bool(g[:, s:].any()) and not w[:, s:].any()
    no_cache = attention.mla_forward(p, torch.from_numpy(x), cfg)
    assert torch.equal(no_cache, got)


@pytest.mark.parametrize("dv,causal", [(32, True), (48, True), (16, False)])
def test_mha_mixed_dims_matches_reference(dv, causal):
    """v narrower than q and k (zero-padded to them, the output's padded
    columns dropped), and as wide."""
    rng = np.random.default_rng(dv)
    q, k = (rng.standard_normal((2, 30, 4, 48)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 30, 4, dv)).astype(np.float32)
    want = jax.jit(lambda a, b, c: ref_attn._mha_mixed_dims(
        a, b, c, causal=causal))(q, k, v)
    got = attention._mha_mixed_dims(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal)
    assert got.shape == (2, 30, 4, dv)
    assert rel(got, want) <= RTOL


def test_eight_absorbed_decode_steps_match_reference():
    """Prefill 20 positions into a 32-slot cache, then 8 decode steps of
    the reference's absorbed form, the port writing its cache in place."""
    rcfg, cfg, rp, p = setup(1)
    s, cl = 20, 32
    x = inputs(cfg, 2, s + 8, 3)
    _, rcache = jax.jit(lambda p_, x_: ref_attn.mla_forward(
        p_, x_, rcfg, return_cache=True, cache_len=cl))(rp, x[:, :s])
    _, cache = attention.mla_forward(p, torch.from_numpy(x[:, :s]), cfg,
                                     return_cache=True, cache_len=cl)
    r_decode = jax.jit(lambda p_, x_, c, pos: ref_attn.mla_decode(
        p_, x_, c, pos, rcfg))
    for i in range(8):
        pos = s + i
        xi = x[:, pos:pos + 1]
        want, rcache = r_decode(rp, xi, rcache, jnp.asarray(pos, jnp.int32))
        c_before = cache.c_kv
        got, cache = attention.mla_decode(p, torch.from_numpy(xi), cache,
                                          pos, cfg)
        assert cache.c_kv is c_before            # written in place
        assert rel(got, want) <= RTOL, f"decode step {i}"
    for name in ("c_kv", "k_rope"):
        assert rel(getattr(cache, name),
                   np.asarray(getattr(rcache, name))) <= RTOL, name


def test_decode_past_the_cache_writes_its_last_slot():
    """pos beyond S_max - 1 writes slot S_max - 1 and attends over the
    whole cache, as the reference's min(pos, s_max - 1)."""
    rcfg, cfg, rp, p = setup(2)
    cl = 12
    x = inputs(cfg, 2, 13, 4)
    _, rcache = ref_attn.mla_forward(rp, x[:, :12], rcfg, return_cache=True,
                                     cache_len=cl)
    _, cache = attention.mla_forward(p, torch.from_numpy(x[:, :12]), cfg,
                                     return_cache=True, cache_len=cl)
    want, rcache = ref_attn.mla_decode(rp, x[:, 12:], rcache,
                                       jnp.asarray(15, jnp.int32), rcfg)
    got, cache = attention.mla_decode(p, torch.from_numpy(x[:, 12:]), cache,
                                      15, cfg)
    assert rel(got, want) <= RTOL
    assert rel(cache.c_kv, np.asarray(rcache.c_kv)) <= RTOL
