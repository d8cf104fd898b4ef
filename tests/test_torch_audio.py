"""hubert-xlarge (the audio encoder) in the port against the reference, on
the CPU, at its reduced config (float32, 1 attn layer, d_model 256, 4
heads of 64, d_ff 512, vocab 504, feature_dim 64, GeLU, layernorm,
non-causal) and at the same config with head_dim 80, hubert's own.

The reference's weights cross through `interop.lm_params_from_numpy`; its
`mask_emb` is zero at init and would hide a wrong mask, so every test
draws it from numpy (0.5 N(0, 1)) first.  The frame features and masks
come from numpy and the reference runs jitted.  Tolerances: `embed_audio`,
every position's logits and `prefill`'s last-position logits and cache to
1e-5 of their scale (float32 matmuls summed in another order than XLA's);
`forward`'s mask-weighted loss to 1e-6 relative and its gradients to 1e-5
of their scale; three train steps' losses to 1e-5 relative, as
tests/test_torch_train.py holds the dense archs; `batches_for` bitwise.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.train import batches_for as ref_batches_for  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models import serving as ref_serving  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.moe import ParallelCtx  # noqa: E402
from repro_torch.configs import SERVED, get_config  # noqa: E402
from repro_torch.interop import (kv_cache_to_numpy,  # noqa: E402
                                 lm_params_from_numpy,
                                 train_state_from_numpy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import serving, transformer  # noqa: E402
from repro_torch.optim.optimizers import tree_items  # noqa: E402

ARCH = "hubert-xlarge"
RTOL = 1e-5
SEQ, BATCH, STEPS, LR = 40, 2, 3, 1e-3
HEAD_DIMS = (None, 80)          # the reduced config's 64, and hubert's 80


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", k)))


def flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def configs(head_dim=None):
    changes = {} if head_dim is None else dict(head_dim=head_dim)
    return (dataclasses.replace(ref_config(ARCH).reduced(), **changes),
            dataclasses.replace(get_config(ARCH).reduced(), **changes))


def setup(head_dim=None):
    """The reduced configs, the reference's weights with `mask_emb` drawn
    from numpy, and the port's model of them."""
    rcfg, cfg = configs(head_dim)
    params = ref_init(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(11)
    params["mask_emb"] = jnp.asarray(
        0.5 * rng.standard_normal(params["mask_emb"].shape), jnp.float32)
    return rcfg, cfg, params, lm_params_from_numpy(cfg, flat(params), "cpu")


def audio(cfg, seed: int, seq: int = SEQ):
    """Frame features (B, S, feature_dim) and a 30 % bool mask, numpy."""
    rng = np.random.default_rng(seed)
    feats = (0.5 * rng.standard_normal((BATCH, seq, cfg.feature_dim))
             ).astype(np.float32)
    return feats, rng.random((BATCH, seq)) < 0.3


def test_registry_serves_hubert_as_the_reference_configures_it():
    assert ARCH in SERVED
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_config(ARCH))
    transformer.require_ported(cfg, training=True)
    assert (cfg.head_dim, cfg.causal, cfg.has_decode) == (80, False, False)


def test_published_width_counts_the_references_parameters():
    """The full config's parameter shapes (no weights made) are the
    reference's, leaf for leaf: 946.9M parameters."""
    cfg = get_config(ARCH)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: ref_init(jax.random.PRNGKey(0), ref_config(ARCH))))
    want = {".".join(_key(k) for k in path): tuple(leaf.shape)
            for path, leaf in leaves}
    got = transformer.param_shapes(cfg)
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == 946896640


@pytest.mark.parametrize("arch", [ARCH, "llama-3.2-vision-11b"])
def test_batches_for_is_the_references(arch):
    cfg = get_config(arch).reduced()
    rcfg = ref_config(arch).reduced()
    for seed in (1, 4):
        got = train.batches_for(cfg, 24, 3, seed=seed)
        want = ref_batches_for(rcfg, 24, 3, seed=seed)
        for _ in range(3):
            x, y = next(got), next(want)
            assert set(x) == set(y)
            for k in x:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k])
    if arch == ARCH:
        assert {"features", "mask"} <= set(x) and "tokens" not in x


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_embed_logits_and_prefill_match(head_dim):
    rcfg, cfg, params, model = setup(head_dim)
    feats, mask = audio(cfg, 3)
    assert mask.any() and not mask.all()
    jx = jtf.embed_audio(params, jnp.asarray(feats), jnp.asarray(mask), rcfg)
    tree = model.tree()
    x = transformer.embed_audio(tree, torch.as_tensor(feats),
                                torch.as_tensor(mask), cfg)
    assert rel(x, jx) <= RTOL
    # every position's logits: the reference's backbone and head, jitted
    jlogits = jax.jit(lambda p, f, m: jtf.lm_logits(p, jtf.backbone_forward(
        p, jtf.embed_audio(p, f, m, rcfg), rcfg, ParallelCtx(),
        jtf.Extras(), remat=False)[0], rcfg))(params, jnp.asarray(feats),
                                              jnp.asarray(mask))
    ops.reset_launch_counts()
    got = steps.make_encode_step(cfg)(model, torch.as_tensor(feats),
                                      torch.as_tensor(mask))
    assert got.shape == (BATCH, SEQ, cfg.vocab_size)
    assert got.dtype == torch.float32
    assert rel(got, jlogits) <= RTOL
    # prefill: no frame masked by default, the last position and the cache
    r_prefill = jax.jit(lambda p, batch: ref_serving.prefill(
        p, batch, rcfg, remat=False))
    want, rcache = r_prefill(params, {"features": jnp.asarray(feats)})
    last, cache = steps.make_prefill_step(cfg)(model, torch.as_tensor(feats))
    assert last.shape == (BATCH, 1, cfg.vocab_size)
    assert rel(last, want) <= RTOL
    rflat, pflat = flat(rcache), kv_cache_to_numpy(cache)
    assert set(pflat) == set(rflat)
    for k in rflat:
        assert pflat[k].shape == rflat[k].shape, k
        assert rel(pflat[k], rflat[k]) <= RTOL, k
    # the encoder unmasked ends where prefill does; the mask changes it
    unmasked = serving.encode(tree, torch.as_tensor(feats), cfg)
    assert rel(unmasked[:, -1:], want) <= RTOL
    assert not torch.allclose(unmasked, got)
    assert ops.launch_counts()["flash_attention"] == 0     # CPU: plain only


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_forward_masked_loss_and_grads_match(head_dim):
    rcfg, cfg, params, model = setup(head_dim)
    feats, mask = audio(cfg, 5)
    targets = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    batch = {"features": feats, "mask": mask, "targets": targets}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        loss, m = jtf.forward(p, jb, rcfg, remat=False)
        return loss + 0.1 * jnp.sum(m["pooled"] ** 2), (loss, m)

    (_, (jl, jm)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    model.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m = transformer.forward(model, tb, cfg, remat=False)
    (loss + 0.1 * torch.sum(m["pooled"] ** 2)).backward()
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl))
    assert rel(m["pooled"].detach(), jm["pooled"]) <= RTOL
    jflat = flat(jg)
    for path, leaf in tree_items(model.tree()):
        want = jflat[".".join(path)]
        if path == ("embed",):      # the audio forward never reads it
            assert leaf.grad is None and not np.any(want)
            continue
        assert rel(leaf.grad, want) <= RTOL, path
    # the loss weighs the masked frames only: the unmasked targets do not
    # move it
    moved = dict(tb, targets=torch.where(tb["mask"], tb["targets"],
                                         (tb["targets"] + 1) % 504))
    with torch.no_grad():
        again, _ = transformer.forward(model, moved, cfg, remat=False)
    assert again.item() == loss.item()


def test_three_train_steps_match():
    rcfg, cfg = configs()
    jopt = jsteps.default_optimizer(rcfg, lr=LR, total_steps=10)
    popt = steps.default_optimizer(cfg, lr=LR, total_steps=10)
    js = jsteps.init_train_state(jax.random.PRNGKey(0), rcfg, jopt)
    m = jnp.asarray(0.5 * np.random.default_rng(12).standard_normal(
        cfg.d_model), jnp.float32)
    js = js._replace(params=dict(js.params, mask_emb=m), opt_state=dict(
        js.opt_state, master=dict(js.opt_state["master"], mask_emb=m)))
    ps = train_state_from_numpy(cfg, flat(js), popt, "cpu")
    jstep = jax.jit(jsteps.make_train_step(rcfg, jopt, remat=True))
    pstep = steps.make_train_step(cfg, popt, remat=True)
    it = train.batches_for(cfg, SEQ, BATCH)
    for i in range(STEPS):
        b = next(it)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pstep(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "lm_loss", "probe_loss"):
            assert abs(float(pm[k]) - float(jm[k])) <= RTOL * abs(
                float(jm[k])), (i, k)
    assert ps.step == STEPS
    # the unread embedding moves by AdamW's weight decay alone, as the
    # reference's zero gradient moves it
    got = ps.params.tree()["embed"].detach().numpy()
    assert rel(got, np.asarray(js.params["embed"])) <= RTOL


def test_train_and_serve_drivers_on_cpu():
    log = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "3", "--seq", "32", "--batch", "2"])
    assert [r["step"] for r in log] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in log)
    with pytest.raises(SystemExit, match="encoder-only.*prefill-only"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


def test_audio_entry_points_refuse_what_they_do_not_take():
    _, cfg, _, model = setup()
    tree = model.tree()
    with pytest.raises(ValueError, match="frame features"):
        serving.prefill(tree, torch.zeros(2, 8, cfg.feature_dim + 1), cfg)
    with pytest.raises(ValueError, match="frame features"):
        serving.encode(tree, torch.zeros(2, 8), cfg)
    text = get_config("gemma2-2b").reduced()
    with pytest.raises(ValueError, match="audio encoder"):
        serving.encode({}, torch.zeros(2, 8, 4), text)
    with pytest.raises(ValueError, match="audio family"):
        serving.prefill({}, torch.zeros(2, 8, dtype=torch.long), text,
                        mask=torch.zeros(2, 8, dtype=torch.bool))


def test_full_depth_training_matches_where_the_head_diverges():
    """hubert's 48 layers at the reduced widths, four steps at the
    driver's lr 3e-4 with no warm-up (a 4-step run's schedule): every
    loss at 1e-5 of JAX's.  The LM loss stays near ln 504, but the AMTL
    head's probe loss on the deep encoder's raw pooled state grows by
    orders of magnitude at step 3, in the reference as in the port (the
    full-width run on the card shows the same)."""
    deep = dict(num_periods=48, num_layers=48)
    rcfg, cfg = (dataclasses.replace(c, **deep) for c in configs())
    jopt = jsteps.default_optimizer(rcfg, lr=3e-4, total_steps=4)
    popt = steps.default_optimizer(cfg, lr=3e-4, total_steps=4)
    js = jsteps.init_train_state(jax.random.PRNGKey(0), rcfg, jopt)
    ps = train_state_from_numpy(cfg, flat(js), popt, "cpu")
    jstep = jax.jit(jsteps.make_train_step(rcfg, jopt, remat=True))
    pstep = steps.make_train_step(cfg, popt, remat=True)
    it = train.batches_for(cfg, 64, BATCH)
    probe = []
    for i in range(4):
        b = next(it)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pstep(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "lm_loss", "probe_loss"):
            assert abs(float(pm[k]) - float(jm[k])) <= RTOL * abs(
                float(jm[k])), (i, k)
        assert abs(float(jm["lm_loss"]) - math.log(504)) < 1.0
        probe.append(float(jm["probe_loss"]))
    assert probe[3] > 100 * max(probe[:3])
