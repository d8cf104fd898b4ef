"""The port's rwkv6-3b serving path against the reference's, on the CPU.

Reduced rwkv6-3b with 2 layers (d_model 256, 8 heads of 32, decay LoRA 16,
chunk 16, d_ff 512, vocab 512, LayerNorm, untied unembedding), float32.
The reference's weights cross through `interop.lm_params_from_numpy`, the
tokens come from numpy, and the reference runs jitted.  Besides the
reference's own init (w0 -6, u 0, mixes 0.5), a perturbed copy draws u,
w0 in [-5, 0] and the mixes in [0, 1] from numpy, so the bonus term and
fast decays are exercised.  Prefill logits, every RWKVState leaf and 8
teacher-forced decode steps are held to 1e-5 of their scale (seen: at most
1.6e-6; the matmuls and einsums sum in another order than XLA's), bf16 to
3e-2 (see its test).  Prompt lengths 16, 37 and 40 fall at, between and
across multiples of the chunk of 16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models import serving as ref_serving  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.moe import ParallelCtx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import (kv_cache_from_numpy,  # noqa: E402
                                 kv_cache_to_numpy, lm_params_from_numpy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import init_params, transformer  # noqa: E402
from repro_torch.models.rwkv import RWKVState  # noqa: E402

RTOL = 1e-5
BF16_RTOL = 3e-2
GEN = 8


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", k)))


def flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def configs(dtype: str = "float32"):
    changes = dict(num_periods=2, num_layers=2, dtype=dtype)
    return (dataclasses.replace(ref_config("rwkv6-3b").reduced(), **changes),
            dataclasses.replace(get_config("rwkv6-3b").reduced(), **changes))


def perturb(params, seed: int):
    """u, w0 and the shift mixes drawn from numpy, the rest as initialized."""
    rng = np.random.default_rng(seed)
    draws = {"u": lambda s: rng.standard_normal(s) * 0.5,
             "w0": lambda s: rng.uniform(-5.0, 0.0, s),
             "mix": lambda s: rng.uniform(0.0, 1.0, s),
             "mix_ffn": lambda s: rng.uniform(0.0, 1.0, s)}

    def leaf(path, x):
        draw = draws.get(_key(path[-1]))
        return x if draw is None else jnp.asarray(draw(x.shape), x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, params)


def setup(dtype: str = "float32", perturbed: bool = True):
    rcfg, cfg = configs(dtype)
    params = ref_init(jax.random.PRNGKey(0), rcfg)
    if perturbed:
        params = perturb(params, 1)
    return rcfg, cfg, params, lm_params_from_numpy(cfg, flat(params), "cpu")


def ref_steps(rcfg, s_max):
    prefill = jax.jit(lambda p, t: ref_serving.prefill(
        p, {"tokens": t}, rcfg, s_max=s_max, remat=False))
    decode = jax.jit(lambda p, c, t, pos: ref_serving.decode_step(
        p, c, t, pos, rcfg))
    return prefill, decode


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def tokens(cfg, prompt_len, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (2, prompt_len + GEN))


@pytest.mark.parametrize("perturbed", [True, False],
                         ids=["perturbed", "reference-init"])
@pytest.mark.parametrize("prompt_len", [16, 37, 40])
def test_prefill_and_decode_match_reference(perturbed, prompt_len):
    rcfg, cfg, params, model = setup(perturbed=perturbed)
    toks = tokens(cfg, prompt_len, prompt_len)
    r_prefill, r_decode = ref_steps(rcfg, prompt_len + GEN)
    ops.reset_launch_counts()

    want, rcache = r_prefill(params, jnp.asarray(toks[:, :prompt_len],
                                                 jnp.int32))
    got, cache = make_prefill_step(cfg, prompt_len + GEN)(
        model, torch.as_tensor(toks[:, :prompt_len]))
    assert got.shape == (2, 1, cfg.vocab_size) and got.dtype == torch.float32
    assert rel(got, want) <= RTOL
    rflat, pflat = flat(rcache), kv_cache_to_numpy(cache)
    assert set(pflat) == set(rflat) == {
        "group0.b0.x_prev_att", "group0.b0.x_prev_ffn", "group0.b0.wkv"}
    for k in rflat:
        assert pflat[k].shape == rflat[k].shape, k
        assert rel(pflat[k], rflat[k]) <= RTOL, k
    assert cache["group0"]["b0"].wkv.dtype == torch.float32

    decode = make_decode_step(cfg)
    for i in range(GEN):           # teacher-forced: the same next tokens
        pos = prompt_len + i
        tok = toks[:, pos:pos + 1]
        want, rcache = r_decode(params, rcache, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos, jnp.int32))
        got, cache = decode(model, cache, torch.as_tensor(tok), pos)
        assert rel(got, want) <= RTOL, f"decode step {i}"
    rflat, pflat = flat(rcache), kv_cache_to_numpy(cache)
    for k in rflat:
        assert rel(pflat[k], rflat[k]) <= RTOL, k
    assert ops.launch_counts()["rwkv6_scan"] == 0        # CPU: plain only


def test_full_sequence_forward_matches_reference():
    """embed_tokens -> backbone_forward -> lm_logits at every position,
    against the reference's (remat off); its last position is prefill's."""
    rcfg, cfg, params, model = setup()
    toks = tokens(cfg, 50, 11)[:, :50]
    x = ref_transformer.embed_tokens(params, jnp.asarray(toks, jnp.int32),
                                     rcfg)
    h, _ = ref_transformer.backbone_forward(
        params, x, rcfg, ParallelCtx(), ref_transformer.Extras(), remat=False)
    want = ref_transformer.lm_logits(params, h, rcfg)
    tree = model.tree()
    with torch.inference_mode():
        h = transformer.backbone_forward(
            tree, transformer.embed_tokens(tree, torch.as_tensor(toks), cfg),
            cfg)
        got = transformer.lm_logits(tree, h, cfg)
    assert got.shape == (2, 50, cfg.vocab_size)
    assert rel(got, want) <= RTOL
    last, _ = make_prefill_step(cfg)(model, torch.as_tensor(toks))
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), rtol=0,
                               atol=RTOL * float(got.abs().max()))


@pytest.mark.parametrize("prompt_len", [16, 37])
def test_decode_equals_own_prefill_over_the_extended_prompt(prompt_len):
    """A decode step after a prefill of p tokens gives the last logits and
    the state of a prefill of p + 1 tokens."""
    _, cfg, _, model = setup()
    toks = torch.as_tensor(tokens(cfg, prompt_len, 3)[:, :prompt_len + 1])
    _, cache = make_prefill_step(cfg)(model, toks[:, :prompt_len])
    dec, cache = make_decode_step(cfg)(model, cache,
                                       toks[:, prompt_len:], prompt_len)
    full, full_cache = make_prefill_step(cfg)(model, toks)
    assert rel(dec, full.numpy()) <= RTOL
    want = kv_cache_to_numpy(full_cache)
    for k, a in kv_cache_to_numpy(cache).items():
        assert rel(a, want[k]) <= RTOL, k


def test_bfloat16_prefill_and_decode_match_reference():
    """bfloat16 weights and activations (w0, u and the WKV state float32).
    Both packages round at other places (XLA fuses, PyTorch rounds each
    op), and the reference's own bf16 run differs from its float32 run by
    up to 2e-2 of scale here, so the two bf16 runs are held to 3e-2 of
    scale; against the float32 reference, the port's bf16 run errs by at
    most 1.5 x the reference's bf16 run."""
    rcfg, cfg, params, model = setup("bfloat16")
    rcfg32 = dataclasses.replace(rcfg, dtype="float32")
    params32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                      params)
    prompt_len = 40
    toks = tokens(cfg, prompt_len, 7)
    r_prefill, r_decode = ref_steps(rcfg, prompt_len + GEN)
    f_prefill, f_decode = ref_steps(rcfg32, prompt_len + GEN)
    prompt = jnp.asarray(toks[:, :prompt_len], jnp.int32)
    want, rcache = r_prefill(params, prompt)
    exact, fcache = f_prefill(params32, prompt)
    got, cache = make_prefill_step(cfg)(model,
                                        torch.as_tensor(toks[:, :prompt_len]))
    errs = [(rel(got, want), rel(got, exact),
             rel(np.asarray(want, np.float32), exact))]
    for i in range(GEN):
        pos = prompt_len + i
        tok = toks[:, pos:pos + 1]
        jtok, jpos = jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32)
        want, rcache = r_decode(params, rcache, jtok, jpos)
        exact, fcache = f_decode(params32, fcache, jtok, jpos)
        got, cache = make_decode_step(cfg)(model, cache, torch.as_tensor(tok),
                                           pos)
        errs.append((rel(got, want), rel(got, exact),
                     rel(np.asarray(want, np.float32), exact)))
    port_vs_ref, port_vs_f32, ref_vs_f32 = (max(e) for e in zip(*errs))
    assert port_vs_ref <= BF16_RTOL, errs
    assert port_vs_f32 <= 1.5 * ref_vs_f32, errs


def test_w0_and_u_stay_float32_in_a_bfloat16_model():
    """lm_params_from_numpy keeps each leaf's reference dtype: w0 and u are
    float32 (bit for bit) in a bf16 model, the rest bf16; the port's own
    init agrees leaf for leaf."""
    rcfg, cfg, params, model = setup("bfloat16")
    want = {k: np.asarray(a).dtype for k, a in flat(params).items()}
    tree = dict(model.named_parameters())
    for path, p in tree.items():
        name = path.rsplit(".", 1)[-1]
        expect = torch.float32 if name in ("w0", "u") else torch.bfloat16
        assert p.dtype == expect, path
        assert str(want[path]) == str(expect).split(".")[1], path
    np.testing.assert_array_equal(
        tree["group0.b0.rwkv.u"].numpy(),
        np.asarray(params["group0"]["b0"]["rwkv"]["u"]))
    own = dict(init_params(cfg, seed=0, device="cpu").named_parameters())
    assert {k: (p.dtype, p.shape) for k, p in own.items()} == \
        {k: (p.dtype, p.shape) for k, p in tree.items()}
    assert transformer.param_dtypes(cfg)["group0.b0.rwkv.w0"] == torch.float32


def test_greedy_generate_matches_reference_greedy_loop():
    rcfg, cfg, params, model = setup()
    prompt_len, gen = 24, 6
    prompts = serve.make_prompts(cfg, 2, prompt_len, seed=3)
    r_prefill, r_decode = ref_steps(rcfg, prompt_len + gen)
    logits, rcache = r_prefill(params, jnp.asarray(prompts, jnp.int32))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        logits, rcache = r_decode(params, rcache, tok,
                                  jnp.asarray(prompt_len + i, jnp.int32))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        want.append(tok)
    got = serve.generate(model, torch.as_tensor(prompts), gen)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))


def test_rwkv_cache_crosses_both_ways():
    rcfg, cfg, params, model = setup()
    toks = tokens(cfg, 20, 1)
    r_prefill, r_decode = ref_steps(rcfg, 28)
    _, rcache = r_prefill(params, jnp.asarray(toks[:, :20], jnp.int32))
    cache = kv_cache_from_numpy(cfg, flat(rcache), "cpu")
    slot = cache["group0"]["b0"]
    assert isinstance(slot, RWKVState) and slot.wkv.dtype == torch.float32
    for k, a in kv_cache_to_numpy(cache).items():
        np.testing.assert_array_equal(a, flat(rcache)[k])
    want, _ = r_decode(params, rcache, jnp.asarray(toks[:, 20:21], jnp.int32),
                       jnp.asarray(20, jnp.int32))
    got, _ = make_decode_step(cfg)(model, cache,
                                   torch.as_tensor(toks[:, 20:21]), 20)
    assert rel(got, want) <= RTOL


def test_serve_cli_runs_on_the_cpu(capsys):
    r = serve.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "19", "--gen", "3"])
    assert r["tokens"].shape == (2, 3)
    out = capsys.readouterr().out
    assert "rwkv6-3b-reduced" in out and "tok/s" in out and "req1:" in out
