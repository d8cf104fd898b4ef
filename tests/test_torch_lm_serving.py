"""The port's gemma2 serving path against the reference's, on the CPU.

Reduced gemma2-2b (2 layers: one local with window 64, one global; d_model
256, 4 heads of 64, softcaps 50 and 30, GeGLU, tied embeddings), float32,
with the reference's kv 4 and a GQA variant with kv 2.  The reference's
weights cross through `interop.lm_params_from_numpy`, the tokens come from
numpy, and the reference runs jitted.  Prefill logits, every KV cache leaf
and 8 teacher-forced decode steps are held to 1e-5 of their scale (seen:
at most 1.6e-6; the matmuls sum in another order than XLA's).

Prompt lengths 40, 64 and 128 are those where the reference's sliding-
window cache is a correct ring (prompt <= window, or a multiple of it).
At 80 the reference's decode evicts a key still in the window; the port's
ring does not (models/attention.py), and the last tests pin that
deliberate difference.
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
from repro_torch.models import transformer  # noqa: E402

RTOL = 1e-5
BF16_RTOL = 2e-2
GEN = 8
WINDOW = 64


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", k)))


def flat(tree) -> dict:
    """A JAX pytree's leaves as numpy arrays keyed by their '.'-joined
    path (what the port's interop takes)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def configs(kv: int = 4, dtype: str = "float32"):
    changes = dict(num_kv_heads=kv, dtype=dtype)
    return (dataclasses.replace(ref_config("gemma2-2b").reduced(), **changes),
            dataclasses.replace(get_config("gemma2-2b").reduced(), **changes))


def setup(kv: int = 4, dtype: str = "float32"):
    rcfg, cfg = configs(kv, dtype)
    params = ref_init(jax.random.PRNGKey(0), rcfg)
    model = lm_params_from_numpy(cfg, flat(params), "cpu")
    return rcfg, cfg, params, model


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


@pytest.mark.parametrize("kv", [4, 2], ids=["kv4", "gqa-kv2"])
@pytest.mark.parametrize("prompt_len", [40, 64, 128])
def test_prefill_and_decode_match_reference(kv, prompt_len):
    rcfg, cfg, params, model = setup(kv)
    toks = tokens(cfg, prompt_len, prompt_len + kv)
    s_max = prompt_len + GEN
    r_prefill, r_decode = ref_steps(rcfg, s_max)
    ops.reset_launch_counts()

    want, rcache = r_prefill(params, jnp.asarray(toks[:, :prompt_len],
                                                 jnp.int32))
    got, cache = make_prefill_step(cfg, s_max)(
        model, torch.as_tensor(toks[:, :prompt_len]))
    assert got.shape == (2, 1, cfg.vocab_size) and got.dtype == torch.float32
    assert rel(got, want) <= RTOL
    rflat, pflat = flat(rcache), kv_cache_to_numpy(cache)
    assert set(pflat) == set(rflat)
    for k in rflat:
        assert pflat[k].shape == rflat[k].shape, k
        assert rel(pflat[k], rflat[k]) <= RTOL, k

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
    assert ops.launch_counts()["flash_attention"] == 0   # CPU: plain only


@pytest.mark.parametrize("kv", [4, 2], ids=["kv4", "gqa-kv2"])
def test_full_sequence_forward_matches_reference(kv):
    """embed_tokens -> backbone_forward -> lm_logits at every position,
    against the reference's (remat off); its last position is prefill's."""
    rcfg, cfg, params, model = setup(kv)
    toks = tokens(cfg, 90, 11)[:, :90]
    x = ref_transformer.embed_tokens(params, jnp.asarray(toks, jnp.int32),
                                     rcfg)
    h, _ = ref_transformer.backbone_forward(
        params, x, rcfg, ParallelCtx(), ref_transformer.Extras(), remat=False)
    want = ref_transformer.lm_logits(params, h, rcfg)
    tree = model.tree()
    with torch.inference_mode():
        h, _ = transformer.backbone_forward(
            tree, transformer.embed_tokens(tree, torch.as_tensor(toks), cfg),
            cfg)
        got = transformer.lm_logits(tree, h, cfg)
    assert got.shape == (2, 90, cfg.vocab_size)
    assert rel(got, want) <= RTOL
    last, _ = make_prefill_step(cfg)(model, torch.as_tensor(toks))
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), rtol=0,
                               atol=RTOL * float(got.abs().max()))


def test_bfloat16_prefill_and_decode_match_reference():
    """bfloat16 weights and activations: both packages round at other
    places (XLA fuses, PyTorch rounds each op), held to 2e-2 of scale."""
    rcfg, cfg, params, model = setup(2, "bfloat16")
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(        # the bits crossed unchanged
        model.embed.float().numpy(), np.asarray(params["embed"], np.float32))
    prompt_len = 64
    toks = tokens(cfg, prompt_len, 7)
    r_prefill, r_decode = ref_steps(rcfg, prompt_len + GEN)
    want, rcache = r_prefill(params, jnp.asarray(toks[:, :prompt_len],
                                                 jnp.int32))
    got, cache = make_prefill_step(cfg, prompt_len + GEN)(
        model, torch.as_tensor(toks[:, :prompt_len]))
    assert rel(got, want) <= BF16_RTOL
    for i in range(GEN):
        pos = prompt_len + i
        tok = toks[:, pos:pos + 1]
        want, rcache = r_decode(params, rcache, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos, jnp.int32))
        got, cache = make_decode_step(cfg)(model, cache, torch.as_tensor(tok),
                                           pos)
        assert rel(got, want) <= BF16_RTOL, f"decode step {i}"


def test_greedy_generate_matches_reference_greedy_loop():
    """The serve driver's greedy loop gives the reference's tokens on the
    same weights and prompts (float32 logits agree to ~1e-6, far below
    the top-2 gaps of these draws)."""
    rcfg, cfg, params, model = setup(2)
    prompt_len, gen = 40, 6
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


def test_kv_cache_crosses_both_ways():
    rcfg, cfg, params, model = setup(2)
    toks = tokens(cfg, 40, 1)
    r_prefill, r_decode = ref_steps(rcfg, 48)
    _, rcache = r_prefill(params, jnp.asarray(toks[:, :40], jnp.int32))
    cache = kv_cache_from_numpy(cfg, flat(rcache), "cpu")
    for k, a in kv_cache_to_numpy(cache).items():
        np.testing.assert_array_equal(a, flat(rcache)[k])
    want, _ = r_decode(params, rcache, jnp.asarray(toks[:, 40:41], jnp.int32),
                       jnp.asarray(40, jnp.int32))
    got, _ = make_decode_step(cfg)(model, cache,
                                   torch.as_tensor(toks[:, 40:41]), 40)
    assert rel(got, want) <= RTOL


def _decode_vs_full_prefill(prefill, decode, toks, prompt_len):
    """max |logits| difference between a decode step after a prefill of
    toks[:, :prompt_len] and the last logits of a prefill of one more."""
    _, cache = prefill(toks[:, :prompt_len], prompt_len + 1)
    dec = decode(cache, toks[:, prompt_len:prompt_len + 1], prompt_len)
    full, _ = prefill(toks[:, :prompt_len + 1], prompt_len + 1)
    return float(np.abs(dec - full).max()), float(np.abs(full).max())


def test_ring_cache_decode_equals_full_prefill_where_reference_does_not():
    """Prompt 80 with window 64: the port's decode equals its own full
    prefill to 1e-5 of scale; the reference's differs from its own by more
    than 1e-2 (its `_fit_cache` puts position p at slot p - 16, its decode
    treats slot p % 64 as p's)."""
    rcfg, cfg, params, model = setup(4)
    toks = tokens(cfg, 80, 80)

    def r_prefill(t, s_max):
        lg, c = ref_steps(rcfg, s_max)[0](params, jnp.asarray(t, jnp.int32))
        return np.asarray(lg), c

    def r_decode(c, t, pos):
        return np.asarray(ref_steps(rcfg, None)[1](
            params, c, jnp.asarray(t, jnp.int32), jnp.asarray(pos, jnp.int32))[0])

    def p_prefill(t, s_max):
        lg, c = make_prefill_step(cfg, s_max)(model, torch.as_tensor(t))
        return lg.numpy(), c

    def p_decode(c, t, pos):
        return make_decode_step(cfg)(model, c, torch.as_tensor(t), pos)[0] \
            .numpy()

    port, scale = _decode_vs_full_prefill(p_prefill, p_decode, toks, 80)
    assert port <= RTOL * scale
    reference, _ = _decode_vs_full_prefill(r_prefill, r_decode, toks, 80)
    assert reference > 1e-2


def test_ring_cache_layout_is_the_references_rolled():
    """After a prompt of 80 the port's local cache holds position p at slot
    p % 64; the reference's holds positions 16..79 at slots 0..63."""
    rcfg, cfg, params, model = setup(4)
    toks = tokens(cfg, 80, 5)
    _, rcache = ref_steps(rcfg, 88)[0](params, jnp.asarray(toks[:, :80],
                                                           jnp.int32))
    _, cache = make_prefill_step(cfg, 88)(model, torch.as_tensor(toks[:, :80]))
    rflat, pflat = flat(rcache), kv_cache_to_numpy(cache)
    local = [k for k in rflat if rflat[k].shape[2] == WINDOW]
    assert local, "the reduced gemma2 has a sliding-window layer"
    for k in local:
        assert rel(pflat[k], np.roll(rflat[k], 80 % WINDOW, axis=2)) <= RTOL
    for k in set(rflat) - set(local):     # global layers: the same layout
        assert rel(pflat[k], rflat[k]) <= RTOL


def test_serve_cli_runs_on_the_cpu(capsys):
    r = serve.main(["--arch", "gemma2-2b", "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert r["tokens"].shape == (2, 3)
    out = capsys.readouterr().out
    assert "gemma2-2b-reduced" in out and "tok/s" in out and "req1:" in out
