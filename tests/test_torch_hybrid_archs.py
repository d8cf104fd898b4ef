"""zamba2-7b and llama-3.2-vision-11b in the port against the reference, on
the CPU, at their reduced configs (float32, d_model 256, 4 heads of 64,
d_ff 512, vocab 512):

- zamba2-7b: 7 layers = (5 mamba + 1 shared_attn) + 1 mamba, Mamba-2 with
  state 16, heads of 32 and chunk 16, one weight-tied attention block with
  rank-64 LoRA deltas on wq and wo at its invocation, GeGLU;
- llama-3.2-vision-11b: 5 layers = 4 attn + 1 cross, SwiGLU, rope theta
  5e5, 16 vision embeddings.

The reduced configs keep kv = heads, so each also runs a GQA variant (4
heads / kv 2 and 4 / kv 1).  The reference's init leaves whole paths
inert: the cross gate is 0 (tanh(0) = 0), the LoRA b matrices are 0, and
the SSD's A_log 0, D 1 and dt_bias 0 are constants.  Every test draws them
from numpy (gate U(0.5, 1.5), LoRA b 0.02 N, A_log U(-1, 1), dt_bias
U(-2, 0), D U(0.5, 1.5), conv_b 0.1 N) into the reference's tree before
its leaves cross to the port through `interop.lm_params_from_numpy`.  The
tokens and the vision embeddings come from numpy and the reference runs
jitted.  Prefill logits, every cache leaf (KVCache, SSMState, CrossKV)
and 8 teacher-forced decode steps are held to 1e-5 of their scale at
prompts 2, 40 and 64 (the matmuls sum in another order than XLA's), and
`forward`'s loss with grad off to 1e-6 relative (its gradients and train
steps: tests/test_torch_hybrid_train.py).
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
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import SERVED, _PENDING, get_config  # noqa: E402
from repro_torch.data import synthetic_lm_batches  # noqa: E402
from repro_torch.interop import (kv_cache_from_numpy,  # noqa: E402
                                 kv_cache_to_numpy, lm_params_from_numpy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import init_params, transformer  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.serving import CrossKV  # noqa: E402
from repro_torch.models.ssm import SSMState  # noqa: E402

RTOL = 1e-5
GEN = 8
ARCHS = ("zamba2-7b", "llama-3.2-vision-11b")
GQA = {"zamba2-7b": (4, 2), "llama-3.2-vision-11b": (4, 1)}
# (arch, (heads, kv heads) or None for the reduced config's, prompt)
CASES = [(a, None, p) for a in ARCHS for p in (2, 40, 64)] \
    + [(a, GQA[a], 40) for a in ARCHS]
# the zero-initialized leaves and what each test draws in their place
DRAWS = {"gate": lambda rng, s: rng.uniform(0.5, 1.5, s),
         "lora_q_b": lambda rng, s: 0.02 * rng.standard_normal(s),
         "lora_o_b": lambda rng, s: 0.02 * rng.standard_normal(s),
         "A_log": lambda rng, s: rng.uniform(-1.0, 1.0, s),
         "dt_bias": lambda rng, s: rng.uniform(-2.0, 0.0, s),
         "D": lambda rng, s: rng.uniform(0.5, 1.5, s),
         "conv_b": lambda rng, s: 0.1 * rng.standard_normal(s)}


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", k)))


def flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def configs(arch: str, heads=None):
    changes = {} if heads is None else dict(num_heads=heads[0],
                                            num_kv_heads=heads[1])
    return (dataclasses.replace(ref_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def perturb(params, seed: int):
    """The reference's tree with DRAWS in place of its inert leaves."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        draw = DRAWS.get(_key(path[-1]))
        return x if draw is None else jnp.asarray(draw(rng, x.shape),
                                                  x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, params)


def setup(arch: str, heads=None):
    rcfg, cfg = configs(arch, heads)
    params = perturb(ref_init(jax.random.PRNGKey(0), rcfg), 1)
    model = lm_params_from_numpy(cfg, flat(params), "cpu")
    return rcfg, cfg, params, model


def vision(cfg, seed: int):
    if cfg.family != "vlm":
        return None
    return serve.make_vision_embeds(cfg, 2, seed)


def ref_steps(rcfg, s_max):
    prefill = jax.jit(lambda p, batch: ref_serving.prefill(
        p, batch, rcfg, s_max=s_max, remat=False))
    decode = jax.jit(lambda p, c, t, pos: ref_serving.decode_step(
        p, c, t, pos, rcfg))
    return prefill, decode


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def tokens(cfg, prompt_len, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (2, prompt_len + GEN))


def test_registry_serves_the_two_archs():
    for arch in ARCHS:
        assert arch in SERVED and arch not in _PENDING
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            ref_config(arch))
        transformer.require_ported(get_config(arch))


@pytest.mark.parametrize("arch,params_m", [("zamba2-7b", 5749.429568),
                                           ("llama-3.2-vision-11b",
                                            10110.734344)])
def test_published_widths_count_their_parameters(arch, params_m):
    """The full configs' parameter counts from their shapes (no weights
    are made): bf16 weights of 11.5 and 20.2 GB, each on one card."""
    shapes = transformer.param_shapes(get_config(arch))
    assert sum(int(np.prod(s)) for s in shapes.values()) == \
        round(params_m * 1e6)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_reference_tree(arch):
    """The port's init has the reference's paths, shapes and dtypes (the
    SSD's A_log, D and dt_bias float32 in a bf16 model), and its inert
    leaves: zero gates and LoRA b."""
    rcfg = dataclasses.replace(ref_config(arch).reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    want = {k: (v.shape, v.dtype.name) for k, v in flat(
        ref_init(jax.random.PRNGKey(0), rcfg)).items()}
    model = init_params(cfg, seed=0, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in model.state_dict().items()}
    assert got == want
    assert got == {k: (v, str(transformer.param_dtypes(cfg)[k]).replace(
        "torch.", "")) for k, v in transformer.param_shapes(cfg).items()}
    for k, v in model.state_dict().items():
        if k.endswith((".gate", ".lora_q_b", ".lora_o_b")):
            assert not bool(v.any()), k


@pytest.mark.parametrize("arch,heads,prompt_len", CASES,
                         ids=[f"{a}-{'gqa' if h else 'base'}-{p}"
                              for a, h, p in CASES])
def test_prefill_and_decode_match_reference(arch, heads, prompt_len):
    rcfg, cfg, params, model = setup(arch, heads)
    toks = tokens(cfg, prompt_len, prompt_len + cfg.num_kv_heads)
    vis = vision(cfg, prompt_len)
    s_max = prompt_len + GEN
    r_prefill, r_decode = ref_steps(rcfg, s_max)
    ops.reset_launch_counts()
    batch = {"tokens": jnp.asarray(toks[:, :prompt_len], jnp.int32)}
    if vis is not None:
        batch["vision_embeds"] = jnp.asarray(vis)
    want, rcache = r_prefill(params, batch)
    got, cache = make_prefill_step(cfg, s_max)(
        model, torch.as_tensor(toks[:, :prompt_len]),
        None if vis is None else torch.as_tensor(vis))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_crosses_from_numpy_and_decodes_on(arch):
    """A prefill's cache (KVCache, SSMState, CrossKV leaves) through
    `kv_cache_to_numpy` and back: the same kinds and bits, and the next
    decode step from it gives the original cache's logits."""
    _, cfg, _, model = setup(arch)
    toks = tokens(cfg, 40, 5)
    vis = vision(cfg, 5)
    _, cache = make_prefill_step(cfg, 41)(
        model, torch.as_tensor(toks[:, :40]),
        None if vis is None else torch.as_tensor(vis))
    back = kv_cache_from_numpy(cfg, kv_cache_to_numpy(cache), "cpu")
    kinds = set()

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
            return
        assert type(a) is type(b)
        kinds.add(type(a))
        for x, y in zip(a, b, strict=True):
            if x is None:       # a model-dtype KVCache's scales
                assert y is None
                continue
            assert x.dtype == y.dtype and torch.equal(x, y)

    walk(cache, back)
    assert kinds == ({KVCache, SSMState} if arch == "zamba2-7b"
                     else {KVCache, CrossKV})
    decode = make_decode_step(cfg)
    tok = torch.as_tensor(toks[:, 40:41])
    want, _ = decode(model, cache, tok, 40)
    got, _ = decode(model, back, tok, 40)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_matches_without_grad(arch):
    rcfg, cfg, params, model = setup(arch)
    vlm = cfg.family == "vlm"
    batch = next(synthetic_lm_batches(
        cfg.vocab_size, 40, 2, cfg.mtl.num_tasks, seed=3,
        vision_seq=cfg.vision_seq if vlm else 0, d_model=cfg.d_model))
    jl, jm = jax.jit(lambda p, b: jtf.forward(p, b, rcfg, remat=False))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, m = transformer.forward(model, tb, cfg, remat=False)
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl))
    assert rel(m["pooled"], jm["pooled"]) <= RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_takes_both_archs(arch):
    """The mamba, shared_attn and cross blocks train (ROADMAP item 11(k)):
    `require_ported` lets both archs train and `make_train_step` builds
    their step (tests/test_torch_hybrid_train.py holds it against the
    reference's)."""
    cfg = get_config(arch)
    transformer.require_ported(cfg, training=True)
    assert {"mamba", "shared_attn", "cross"} <= set(
        transformer.TRAINED_KINDS)
    assert callable(steps.make_train_step(cfg.reduced(),
                                          steps.default_optimizer(cfg)))


def test_vlm_prefill_needs_its_vision_embeddings():
    _, cfg, _, model = setup("llama-3.2-vision-11b")
    toks = torch.as_tensor(tokens(cfg, 8, 0)[:, :8])
    prefill = make_prefill_step(cfg)
    with pytest.raises(ValueError, match="vision"):
        prefill(model, toks)
    with pytest.raises(ValueError, match="vision"):
        prefill(model, toks, torch.zeros(2, cfg.vision_seq + 1, cfg.d_model))


def test_vision_embeds_are_seeded_and_scaled():
    cfg = get_config("llama-3.2-vision-11b").reduced()
    a = serve.make_vision_embeds(cfg, 3, 7)
    assert a.shape == (3, cfg.vision_seq, cfg.d_model)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, serve.make_vision_embeds(cfg, 3, 7))
    assert not np.array_equal(a, serve.make_vision_embeds(cfg, 3, 8))
    assert 0.04 < float(a.std()) < 0.06
    assert serve.make_vision_embeds(get_config("zamba2-7b"), 3, 7) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_runs_on_the_cpu(arch, capsys):
    r = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert r["tokens"].shape == (2, 3)
    out = capsys.readouterr().out
    assert f"{arch}-reduced" in out and "tok/s" in out


def chip_smoke():
    """chip_smoke.py at the repository's root, imported as a module (its
    helpers import torch and the port inside each function)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,launches", [
    ("zamba2-7b", 13), ("llama-3.2-vision-11b", 48), ("gemma2-2b", 26),
    ("rwkv6-3b", 32), ("gemma3-12b", 48)])
def test_chip_smoke_counts_a_pass_by_block_kind(arch, launches):
    """The serve phases' launches a pass: one an attention call or WKV
    (13 shared_attn invocations in zamba2-7b's 81 layers), two a cross
    layer (40 self + 8 cross in llama-3.2-vision-11b)."""
    assert chip_smoke().pass_launches(get_config(arch)) == launches


CROSS_CASES = [  # (Sq, Skv, H, Hkv, causal, q_offset, kv_valid_len)
    (40, 40, 4, 4, True, 0, None), (1, 48, 4, 2, False, 40, 41),
    (24, 16, 4, 1, False, 0, None), (1, 16, 4, 1, False, 0, None)]


@pytest.mark.parametrize("case", CROSS_CASES)
def test_chip_smoke_second_plain_attention_matches_mha_ref(case):
    """`mha_dense_plain`, the hybrid serves' bf16 noise yardstick, is the
    model's attention: against `ref.mha_ref` at self, decode and cross
    shapes in float32."""
    from repro_torch.kernels import ref
    sq, skv, h, hkv, causal, qo, kvl = case
    g = torch.Generator().manual_seed(sq + skv)
    q = torch.randn(2, sq, h, 64, generator=g)
    k = torch.randn(2, skv, hkv, 64, generator=g)
    v = torch.randn(2, skv, hkv, 64, generator=g)
    kw = dict(causal=causal, q_offset=qo, kv_valid_len=kvl)
    got = chip_smoke().mha_dense_plain(q, k, v, **kw)
    assert rel(got, ref.mha_ref(q, k, v, **kw).numpy()) <= RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_wakes_the_inert_leaves(arch):
    """The card phases' draws replace every zero gate, LoRA b and SSD
    constant of the port's init, within their ranges; nothing else
    changes."""
    cs = chip_smoke()
    cfg = get_config(arch).reduced()
    model = init_params(cfg, seed=0, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    drawn = cs.wake_inert_leaves(model, 0)
    names = {p.rsplit(".", 1)[-1] for p in drawn}
    assert names == ({"A_log", "D", "dt_bias", "conv_b", "lora_q_b",
                      "lora_o_b"} if arch == "zamba2-7b" else {"gate"})
    after = model.state_dict()
    for k, v in after.items():
        if k in drawn:
            assert bool((v != before[k]).all()), k
            lo_hi = {"gate": (0.5, 1.5), "A_log": (-1, 1),
                     "dt_bias": (-2, 0), "D": (0.5, 1.5)}.get(
                         k.rsplit(".", 1)[-1])
            if lo_hi:
                assert lo_hi[0] <= float(v.min()) <= float(v.max()) \
                    <= lo_hi[1], k
        else:
            assert torch.equal(v, before[k]), k
