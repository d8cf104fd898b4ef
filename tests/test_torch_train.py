"""The port's training path against the reference's, on the CPU:
gemma2-2b `--reduced` (2 layers: one local with window 64, one global;
d_model 256, 4 heads of 64, softcaps 50 and 30, GeGLU, tied embeddings,
float32; the MTL head with T 4, tau 4, nuclear).

The reference's weights and training state cross through `interop`, the
batches are `synthetic_lm_batches`' (bitwise the reference's), and the
reference runs jitted.  Tolerances: `forward`'s loss to 1e-6 relative and
`pooled` and the gradients to 1e-5 of their scale (float32 matmuls summed
in another order; seen at most 2e-6); three train steps' losses to 1e-5
relative; the params after them within 2 lr a step of the reference's
(Adam's update is lr times about sign(g) early on, so an element whose
gradient is near 0 can land up to 2 lr away; seen 0.03 lr); the head's
ring to 1e-5 of its scale and its draws and counters bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import synthetic_lm_batches as ref_batches  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import ShardedBatcher, synthetic_lm_batches  # noqa: E402
from repro_torch.interop import (lm_params_from_numpy,  # noqa: E402
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim.optimizers import tree_items  # noqa: E402

SEQ, BATCH, STEPS, LR = 32, 2, 3, 1e-3


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", k)))


def flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    rcfg = ref_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    params = jtf.init_params(jax.random.PRNGKey(0), rcfg)
    batch = next(synthetic_lm_batches(cfg.vocab_size, SEQ, BATCH,
                                      cfg.mtl.num_tasks, seed=1))
    return rcfg, cfg, params, batch


def test_synthetic_lm_batches_are_the_references():
    for kw in (dict(seed=1), dict(seed=7)):
        a = synthetic_lm_batches(512, 48, 3, 4, **kw)
        b = ref_batches(512, 48, 3, 4, **kw)
        for _ in range(3):
            x, y = next(a), next(b)
            assert set(x) == set(y)
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])


def test_batcher_places_each_batch_one_ahead():
    it = synthetic_lm_batches(64, 8, 2, 4, seed=3)
    want = [next(synthetic_lm_batches(64, 8, 2, 4, seed=3))]
    data = ShardedBatcher(it, device="cpu")
    first = next(data)
    assert data._next is not None           # the next one already placed
    for k, v in want[0].items():
        assert torch.equal(first[k], torch.from_numpy(v))


def test_forward_loss_pooled_and_grads_match(setup):
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
    assert float(m["aux_loss"]) == 0.0
    assert rel(m["pooled"].detach(), jm["pooled"]) <= 1e-5
    jflat = flat(jg)
    for path, leaf in tree_items(model.tree()):
        assert rel(leaf.grad, jflat[".".join(path)]) <= 1e-5, path


def test_remat_on_equals_remat_off(setup):
    _, cfg, params, batch = setup
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = []
    for remat in (False, True):
        model = lm_params_from_numpy(cfg, flat(params), "cpu")
        model.requires_grad_(True)
        loss, m = transformer.forward(model, tb, cfg, remat=remat)
        (loss + torch.sum(m["pooled"])).backward()
        grads.append((loss.item(), {p: leaf.grad for p, leaf in
                                    tree_items(model.tree())}))
    assert grads[0][0] == grads[1][0]
    for p, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][p]), p


def test_three_train_steps_match(setup):
    rcfg, cfg, _, _ = setup
    jopt = jsteps.default_optimizer(rcfg, lr=LR, total_steps=10)
    popt = steps.default_optimizer(cfg, lr=LR, total_steps=10)
    js = jsteps.init_train_state(jax.random.PRNGKey(0), rcfg, jopt)
    ps = train_state_from_numpy(cfg, flat(js), popt, "cpu")
    jstep = jax.jit(jsteps.make_train_step(rcfg, jopt, remat=True))
    pstep = steps.make_train_step(cfg, popt, remat=True)
    it = synthetic_lm_batches(cfg.vocab_size, SEQ, BATCH, cfg.mtl.num_tasks,
                              seed=1)
    ops.reset_launch_counts()
    for i in range(STEPS):
        b = next(it)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pstep(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        assert ps.step == i + 1
        assert set(jm) <= set(pm)
        for k in ("loss", "lm_loss", "probe_loss"):
            assert abs(float(pm[k]) - float(jm[k])) <= 1e-5 * abs(
                float(jm[k])), (i, k)
        assert float(pm["mtl_active_frac"]) == float(jm["mtl_active_frac"])
        assert float(pm["mtl_mean_staleness"]) == float(
            jm["mtl_mean_staleness"])
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    want, got = flat(js), train_state_to_numpy(ps)
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("params."):
            assert np.abs(got[k] - w).max() <= 2 * LR * STEPS, k
    assert rel(got["mtl.ring"], want["mtl.ring"]) <= 1e-5
    for k in ("mtl.ptr", "mtl.step", "mtl.delay_buf", "mtl.delay_cnt",
              "step"):
        np.testing.assert_array_equal(got[k], want[k])


def test_train_step_draws_are_the_key_chains():
    """The head's staleness comes from k_read and its mask from the second
    half of split(k_act), as the reference's step splits its key twice."""
    cfg = get_config("gemma2-2b").reduced()
    for step in (0, 1, 5, 1000):
        key = jax.random.fold_in(jax.random.PRNGKey(17), step)
        k_read, k_act = jax.random.split(key)
        got = steps.train_keys(step)
        np.testing.assert_array_equal(got[0], np.asarray(k_read))
        np.testing.assert_array_equal(got[1], np.asarray(k_act))
        mask = np.asarray(jax.random.bernoulli(
            jax.random.split(k_act)[1], cfg.mtl.activation_rate,
            (cfg.mtl.num_tasks,)))
        np.testing.assert_array_equal(
            prng.bernoulli(prng.split(got[1])[1], cfg.mtl.activation_rate,
                           (cfg.mtl.num_tasks,)), mask)


def test_rwkv_training_raises_naming_its_roadmap_item():
    """rwkv trains since its WKV backward kernel came (ROADMAP item 11(j),
    done), the MoE FFN since item 11(l), and a config with the int8 KV
    cache since item 11(f) (training builds no cache); a kind the port
    lacks raises naming item 11."""
    cfg = get_config("rwkv6-3b").reduced()
    steps.make_train_step(cfg, steps.default_optimizer(cfg))
    moe = dataclasses.replace(cfg, period=("moe",),
                              moe=get_config("dbrx-132b").reduced().moe)
    steps.make_train_step(moe, steps.default_optimizer(moe))
    int8 = dataclasses.replace(moe, kv_cache_dtype="int8")
    steps.make_train_step(int8, steps.default_optimizer(int8))
    bad = dataclasses.replace(cfg, period=("no-such-kind",))
    with pytest.raises(NotImplementedError, match=r"item 11"):
        steps.make_train_step(bad, steps.default_optimizer(bad))


def test_train_driver_on_cpu_writes_a_record_jax_restores(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    argv = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "16", "--log-every",
            "1", "--lr", "1e-3", "--ckpt", ckpt]
    log = train.main(argv)
    assert [r["step"] for r in log] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in log)
    rcfg = dataclasses.replace(ref_config("gemma2-2b").reduced(),
                               name="gemma2-2b-reduced")
    like = jtf.init_params(jax.random.PRNGKey(0), rcfg)
    assert jckpt.latest_step(ckpt) == 3
    back = flat(jckpt.restore(ckpt, 3, like))
    # the record holds the port's params after 3 steps: a resumed run
    # starts from them and takes no step (3 of 3 done)
    again = train.main(argv)
    assert again == []
    model = lm_params_from_numpy(
        dataclasses.replace(get_config("gemma2-2b").reduced(),
                            name="gemma2-2b-reduced"), back, "cpu")
    resumed = train.main(argv[:-2] + ["--steps", "4", "--ckpt", ckpt])
    assert [r["step"] for r in resumed] == [3]
    assert model.num_params() == sum(v.size for v in back.values())
