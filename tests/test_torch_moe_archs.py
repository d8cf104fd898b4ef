"""dbrx-132b and deepseek-v3-671b in the port against the reference, on
the CPU, at their reduced configs (float32, d_model 256, 4 heads of 64,
vocab 512, 4 experts top-2 of d_expert 128, SwiGLU):

- dbrx-132b: 1 layer, a moe block (GQA attention and the routed MoE FFN),
  rope theta 5e5;
- deepseek-v3-671b: 2 layers, a dense attn block and a moe block with one
  shared expert, MLA in both (q_lora 64, kv_lora 32, nope 32, rope 16, v
  32), and the MTP leaves, which serving never reads.

The reduced dbrx keeps kv = heads, so it also runs a GQA variant (4 heads
/ kv 2); MLA has no kv heads.  The reference's weights cross through
`interop.lm_params_from_numpy`, the tokens come from numpy, and the
reference runs jitted.  Prefill logits, every cache leaf (KVCache,
MLACache) and 8 teacher-forced decode steps are held to 1e-5 of their
scale at prompts 2, 40 and 64 (matmuls and the MoE's sums in other orders
than XLA's), dbrx's `forward` loss and aux loss with grad off to 1e-6
relative.  The published widths are held to the reference's tree by
`jax.eval_shape` of its init, with nothing materialised.
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
from repro_torch.models.attention import KVCache, MLACache  # noqa: E402

RTOL = 1e-5
GEN = 8
ARCHS = ("dbrx-132b", "deepseek-v3-671b")
# (arch, (heads, kv heads) or None for the reduced config's, prompt)
CASES = [(a, None, p) for a in ARCHS for p in (2, 40, 64)] \
    + [("dbrx-132b", (4, 2), 40)]


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


def setup(arch: str, heads=None):
    rcfg, cfg = configs(arch, heads)
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
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def tokens(cfg, prompt_len, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (2, prompt_len + GEN))


def test_registry_serves_every_arch_of_the_reference():
    """Both configs load equal to the reference's; nothing is pending; both
    serve and, since item 11(l), train."""
    assert _PENDING == {}
    for arch in ARCHS:
        assert arch in SERVED
        cfg = get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            ref_config(arch))
        transformer.require_ported(cfg)
        transformer.require_ported(cfg, training=True)
    assert get_config("dbrx-132b").citation == "hf:databricks/dbrx-base"
    assert get_config("deepseek-v3-671b").citation == "arXiv:2412.19437"


@pytest.mark.parametrize("arch,params_m", [("dbrx-132b", 131596.52352),
                                           ("deepseek-v3-671b",
                                            671712.65536)])
def test_published_widths_count_their_parameters(arch, params_m):
    """The full configs' trees against `jax.eval_shape` of the reference's
    init (nothing is made on either side): the same paths and shapes,
    263.2 and 1343.4 GB of bf16 weights, the MTP leaves among them."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    abstract, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda key: ref_init(key, rcfg), jax.random.PRNGKey(0)))
    want = {".".join(_key(k) for k in path): tuple(leaf.shape)
            for path, leaf in abstract}
    shapes = transformer.param_shapes(cfg)
    assert shapes == want
    assert sum(int(np.prod(s)) for s in shapes.values()) == \
        round(params_m * 1e6)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_reference_tree(arch):
    """The port's init has the reference's paths, shapes and dtypes: the
    MoE router float32 in a bf16 model, MLA's leaves and the `mtp`
    subtree."""
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
    routers = [k for k in got if k.endswith(".moe.router")]
    assert routers and all(got[k][1] == "float32" for k in routers)
    assert any(k.startswith("mtp.") for k in got) == (arch ==
                                                      "deepseek-v3-671b")


@pytest.mark.parametrize("arch,heads,prompt_len", CASES,
                         ids=[f"{a}-{'gqa' if h else 'base'}-{p}"
                              for a, h, p in CASES])
def test_prefill_and_decode_match_reference(arch, heads, prompt_len):
    rcfg, cfg, params, model = setup(arch, heads)
    toks = tokens(cfg, prompt_len, prompt_len + cfg.num_kv_heads)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_crosses_from_numpy_and_decodes_on(arch):
    """A prefill's cache (KVCache or MLACache leaves) through
    `kv_cache_to_numpy` and back: the same kinds and bits, and the next
    decode step from it gives the original cache's logits."""
    _, cfg, _, model = setup(arch)
    toks = tokens(cfg, 40, 5)
    _, cache = make_prefill_step(cfg, 41)(model, torch.as_tensor(
        toks[:, :40]))
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
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)

    walk(cache, back)
    assert kinds == ({KVCache} if arch == "dbrx-132b" else {MLACache})
    decode = make_decode_step(cfg)
    tok = torch.as_tensor(toks[:, 40:41])
    want, _ = decode(model, cache, tok, 40)
    got, _ = decode(model, back, tok, 40)
    assert torch.equal(got, want)


def test_dbrx_forward_loss_and_aux_match_without_grad():
    """`forward` with grad off: the loss (the LM loss plus
    aux_loss_weight x the Switch aux loss), the aux loss and the pooled
    state against the reference's."""
    rcfg, cfg, params, model = setup("dbrx-132b")
    batch = next(synthetic_lm_batches(cfg.vocab_size, 40, 2,
                                      cfg.mtl.num_tasks, seed=3))
    jl, jm = jax.jit(lambda p, b: jtf.forward(p, b, rcfg, remat=False))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, m = transformer.forward(model, tb, cfg, remat=False)
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl))
    aux = float(jm["aux_loss"])
    assert aux > 0 and abs(m["aux_loss"].item() - aux) <= 1e-6 * aux
    assert abs(m["lm_loss"].item() - float(jm["lm_loss"])) \
        <= 1e-6 * abs(float(jm["lm_loss"]))
    assert rel(m["pooled"], jm["pooled"]) <= RTOL


def test_backbone_forward_sums_the_aux_loss_in_layer_order():
    """deepseek's backbone: its dense block adds 0, its moe block the
    router's aux, as the reference's scan carries it."""
    rcfg, cfg, params, model = setup("deepseek-v3-671b")
    toks = tokens(cfg, 30, 9)[:, :30]
    x = jtf.embed_tokens(params, jnp.asarray(toks, jnp.int32), rcfg)
    h_r, aux_r = jax.jit(lambda p, x_: jtf.backbone_forward(
        p, x_, rcfg, jtf.ParallelCtx(), jtf.Extras(), remat=False))(params, x)
    tree = model.tree()
    with torch.inference_mode():
        h, aux = transformer.backbone_forward(
            tree, transformer.embed_tokens(tree, torch.as_tensor(toks), cfg),
            cfg)
    assert rel(h, h_r) <= RTOL
    assert abs(aux.item() - float(aux_r)) <= 1e-6 * abs(float(aux_r))


@pytest.mark.parametrize("arch", ARCHS)
def test_training_and_the_mtp_loss_still_raise(arch):
    """MoE, MLA and MTP train since item 11(l): the train step takes both
    archs, and deepseek's `forward` returns the MTP loss (with grad off
    too), added to the loss at mtp_weight beside the aux loss; only the
    int8 cache (item 11(f)) still raises."""
    cfg = get_config(arch).reduced()
    assert callable(steps.make_train_step(cfg, steps.default_optimizer(cfg)))
    model = init_params(cfg, seed=0, device="cpu")
    batch = next(synthetic_lm_batches(cfg.vocab_size, 8, 2,
                                      cfg.mtl.num_tasks, seed=0))
    with torch.no_grad():
        loss, m = transformer.forward(model, {k: torch.from_numpy(v)
                                              for k, v in batch.items()},
                                      cfg)
    assert ("mtp_loss" in m) == cfg.mtp
    want = m["lm_loss"] + cfg.moe.aux_loss_weight * m["aux_loss"] + (
        cfg.mtp_weight * m["mtp_loss"] if cfg.mtp else 0.0)
    assert abs(loss.item() - float(want)) <= 1e-6 * abs(loss.item())
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match=r"item 11\(f\)"):
        steps.make_train_step(int8, steps.default_optimizer(int8))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_driver_runs_on_the_cpu(arch, capsys):
    r = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert r["tokens"].shape == (2, 3)
    out = capsys.readouterr().out
    assert f"{arch}-reduced" in out and "tok/s" in out


def test_serve_config_cuts_the_depth_and_keeps_every_width():
    """--periods keeps the first N repeats of the period and the head
    blocks: deepseek's 3 dense layers and 2 of its 58 MoE layers."""
    full = get_config("deepseek-v3-671b")
    cut = serve.serve_config("deepseek-v3-671b", periods=2)
    assert (cut.num_layers, cut.num_periods, cut.head_blocks) == (
        5, 2, ("attn",) * 3)
    assert dataclasses.replace(cut, num_layers=full.num_layers,
                               num_periods=full.num_periods) == full
    assert serve.serve_config("dbrx-132b", periods=8).num_layers == 8
    r = serve.main(["--arch", "dbrx-132b", "--reduced", "--periods", "2",
                    "--device", "cpu", "--batch", "1", "--prompt-len", "4",
                    "--gen", "2"])
    assert r["tokens"].shape == (1, 2)


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


@pytest.mark.parametrize("arch,periods,prefill,decode", [
    ("dbrx-132b", 8, 8, 8), ("deepseek-v3-671b", 2, 5, 0),
    ("deepseek-v3-671b", 58, 61, 0), ("gemma2-2b", None, 26, 26)])
def test_chip_smoke_counts_a_pass_by_block_kind(arch, periods, prefill,
                                                decode):
    """The serve phases' flash launches a prefill and a decode step: one an
    attention block in both for GQA archs (a moe block's attention among
    them), one an MLA block in prefill and none in decode (the absorbed
    decode is plain PyTorch)."""
    cs = chip_smoke()
    cfg = serve.serve_config(arch, periods=periods)
    assert cs.pass_launches(cfg) == prefill
    assert cs.pass_launches(cfg, decode=True) == decode


def test_chip_smoke_float32_model_cuts_over_several_scan_groups(
        monkeypatch):
    """`float32_model` keeps whole scan groups while their float32 weights
    fit F32_WEIGHTS_BYTES, cuts the last group it keeps to the periods
    that fit, and drops the groups after it: at a budget that holds the
    rest and the dense block but not the moe block, deepseek's reduced
    model keeps its dense layer and no moe layer, and its float32 prefill
    runs; at one that holds everything, nothing is cut."""
    cs = chip_smoke()
    cfg = dataclasses.replace(get_config("deepseek-v3-671b").reduced(),
                              dtype="bfloat16", head_blocks=("attn",) * 2,
                              num_periods=3, num_layers=5)
    model = init_params(cfg, seed=0, device="cpu")
    sizes = {k: v.numel() for k, v in model.state_dict().items()}
    f32 = 4 * sum(sizes.values())
    moe_layer = 4 * sum(n for k, n in sizes.items()
                        if k.startswith("group1.")) // 3
    dense_layer = 4 * sum(n for k, n in sizes.items()
                          if k.startswith("group0.")) // 2
    monkeypatch.setattr(cs, "F32_WEIGHTS_BYTES",
                        f32 - 3 * moe_layer + moe_layer // 2)
    m32, cfg32, keep, full = cs.float32_model(model.tree(), cfg)
    assert full == f32 and keep == {"group0": 2, "group1": 0}
    assert (cfg32.num_layers, cfg32.num_periods, cfg32.dtype) == (
        2, 0, "float32")
    assert set(m32.tree()) == {"embed", "unembed", "final_norm", "group0",
                               "mtp"}
    assert all(v.dtype == torch.float32 for v in m32.state_dict().values())
    assert transformer.param_shapes(cfg32) == {
        k: tuple(v.shape) for k, v in m32.state_dict().items()}
    lg, _ = make_prefill_step(cfg32)(m32, torch.as_tensor(
        tokens(cfg32, 6, 0)[:1, :6]))
    assert bool(torch.isfinite(lg).all())
    monkeypatch.setattr(cs, "F32_WEIGHTS_BYTES",
                        f32 - 3 * moe_layer - dense_layer // 2)
    _, cfg32, keep, _ = cs.float32_model(
        init_params(cfg, seed=0, device="cpu").tree(), cfg)
    assert keep == {"group0": 1, "group1": 0} and cfg32.num_layers == 1
    monkeypatch.setattr(cs, "F32_WEIGHTS_BYTES", f32)
    _, cfg32, keep, _ = cs.float32_model(
        init_params(cfg, seed=0, device="cpu").tree(), cfg)
    assert keep == {"group0": 2, "group1": 3} and cfg32.num_layers == 5


@pytest.mark.parametrize("causal,kv_valid_len", [(True, None),
                                                 (False, 37)])
def test_chip_smoke_lean_plain_attentions_match_mha_ref(monkeypatch, causal,
                                                        kv_valid_len):
    """deepseek's plain attentions on the card take smaller blocks
    (`plain_rows`: a block's float32 scores under PLAIN_BLOCK_BYTES): with
    the budget cut here to a few rows and keys, `mha_ref_lean` and
    `mha_dense_plain` still equal `ref.mha_ref` in float32; at the card's
    budget a block takes 1024 rows at hubert-xlarge's encoder, 781 at a
    32-head prefill of 5000 and 195 at deepseek's 128 heads."""
    from repro_torch.kernels import ref
    cs = chip_smoke()
    assert (cs.plain_rows(8, 16, 781), cs.plain_rows(2, 32, 5000),
            cs.plain_rows(2, 128, 5000)) == (1024, 781, 195)
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 50, 4, 48, generator=g)
    k, v = (torch.randn(2, 50, 4, 48, generator=g) for _ in range(2))
    kw = dict(causal=causal, kv_valid_len=kv_valid_len)
    want = ref.mha_ref(q, k, v, **kw).numpy()
    monkeypatch.setattr(cs, "PLAIN_BLOCK_BYTES", 4 * 2 * 4 * 50 * 7)
    assert cs.plain_rows(2, 4, 50) == 7
    assert rel(cs.mha_ref_lean(q, k, v, **kw), want) <= RTOL
    assert rel(cs.mha_dense_plain(q, k, v, **kw), want) <= RTOL
