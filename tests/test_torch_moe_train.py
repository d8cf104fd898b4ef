"""dbrx-132b and deepseek-v3-671b training in the port against the
reference's, on the CPU, at their reduced configs (float32, d_model 256, 4
heads, vocab 512, 4 experts top-2 of d_expert 128, SwiGLU):

- dbrx-132b with 2 periods (2 moe layers: GQA attention and the routed
  MoE FFN), so the stacked expert weights' gradient gathers two layers;
- deepseek-v3-671b as reduced: a dense MLA block, a moe block with one
  shared expert, and the MTP block (MLA q_lora 64, kv_lora 32, nope 32 +
  rope 16, v 32 zero-padded to 48 in the attention call).

The reference's weights cross by `interop.lm_params_from_numpy`, the
batches are `batches_for`'s, and the reference runs jitted.

Tolerances: `forward`'s loss, LM loss, aux loss and MTP loss to 1e-6
relative; `pooled` and every leaf's gradient to 1e-5 of its scale (max
|diff| over max |grad|; float32 matmuls and the MoE's sums in other orders
than XLA's), as tests/test_torch_hybrid_train.py holds the hybrid archs.
Three train steps with each arch's `default_optimizer` (AdamW for dbrx,
Adafactor for deepseek): the losses to 1e-5 of the step's loss, the head's
draws and counters bitwise, its ring to 1e-5 of its scale after step 0
and 1e-4 after, as there.  Each parameter leaf's update over the three
steps (its value less its initial one) against the reference's:
||got - want|| / ||want|| within UPDATE_RTOL (read: at most 1.9e-4 under
AdamW, 1.3e-5 under Adafactor), so a step left out (~0.33) or a leaf never
updated (1.0) fails.  Elementwise, Adafactor's update within
ADAFACTOR_UPDATE_RTOL of its max (read: at most 3.4e-5, a float32 ulp of
the norm scales near 1 against their 3.3e-3 update), and AdamW's within 2
lr a step: an element whose gradient is near zero takes Adam's update
m/sqrt(v) of either sign on a rounding (read: at most 0.034 of the
update's max, 1.0e-4 against the 6e-3 allowed).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.core.mtl_head import init_mtl_state as ref_mtl_state  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import (lm_params_from_numpy,  # noqa: E402
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import attention, moe, transformer  # noqa: E402
from repro_torch.optim.optimizers import tree_items  # noqa: E402
from test_torch_hybrid_archs import chip_smoke, flat, rel  # noqa: E402

RTOL = 1e-5
LOSS_RTOL = 1e-6
RING_DRIFT_RTOL = 1e-4
UPDATE_RTOL = 1e-3
ADAFACTOR_UPDATE_RTOL = 1e-4
SEQ, BATCH, STEPS, LR = 32, 2, 3, 1e-3
ARCHS = ("dbrx-132b", "deepseek-v3-671b")
PERIODS = {"dbrx-132b": 2, "deepseek-v3-671b": 1}
# leaves that must get a gradient that is not zero (a name or a dotted
# suffix of the path; "mtp." a prefix)
NONZERO = {"dbrx-132b": ("moe.router", "moe.w_in", "moe.w_gate",
                         "moe.w_out", "attn.wq", "attn.wk", "attn.wv"),
           "deepseek-v3-671b": ("moe.router", "moe.w_in", "moe.shared_in",
                                "attn.wq_a", "attn.wq_b", "attn.wkv_a",
                                "attn.wk_b", "attn.wv_b", "attn.wo",
                                "mtp.")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread a worker, as the other training files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch: str):
    """(the reference's, the port's) reduced config at PERIODS[arch]."""
    def cut(cfg):
        cfg = cfg.reduced()
        p = PERIODS[arch]
        return dataclasses.replace(
            cfg, num_periods=p, num_layers=len(cfg.head_blocks)
            + len(cfg.period) * p + len(cfg.tail_blocks))
    return cut(ref_config(arch)), cut(get_config(arch))


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """The reference's weights, a batch, and its jitted loss, metrics and
    gradient of loss + 0.1 |pooled|^2 (so `pooled` has a gradient of its
    own)."""
    arch = request.param
    rcfg, cfg = configs(arch)
    params = ref_init(jax.random.PRNGKey(0), rcfg)
    batch = next(train.batches_for(cfg, SEQ, BATCH, seed=3))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        loss, m = jtf.forward(p, jb, rcfg)
        return loss + 0.1 * jnp.sum(m["pooled"] ** 2), (loss, m)

    (_, (jl, jm)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    return dict(arch=arch, rcfg=rcfg, cfg=cfg, params=params, batch=batch,
                loss=float(jl), metrics={k: np.asarray(v)
                                         for k, v in jm.items()},
                grads=flat(jg))


def port_grads(case, remat: bool) -> tuple:
    model = lm_params_from_numpy(case["cfg"], flat(case["params"]), "cpu")
    model.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    loss, m = transformer.forward(model, tb, case["cfg"], remat=remat)
    (loss + 0.1 * torch.sum(m["pooled"] ** 2)).backward()
    return loss.item(), m, {".".join(p): leaf.grad
                            for p, leaf in tree_items(model.tree())}


def test_forward_losses_pooled_and_grads_match(case):
    ops.reset_launch_counts()
    loss, m, grads = port_grads(case, remat=True)
    want = case["metrics"]
    mtp = case["cfg"].mtp
    assert set(m) == set(want) == {"lm_loss", "aux_loss", "pooled"} | (
        {"mtp_loss"} if mtp else set())
    assert abs(loss - case["loss"]) <= LOSS_RTOL * abs(case["loss"])
    for k in ("lm_loss", "aux_loss") + (("mtp_loss",) if mtp else ()):
        assert float(want[k]) > 0, k
        assert abs(m[k].item() - float(want[k])) <= LOSS_RTOL * abs(
            float(want[k])), k
    assert rel(m["pooled"], want["pooled"]) <= RTOL
    assert set(grads) == set(case["grads"])
    for path, g in grads.items():
        assert g is not None and g.dtype == transformer.param_dtypes(
            case["cfg"])[path], path
        assert rel(g, case["grads"][path]) <= RTOL, path
    named = chip_smoke().named
    live = [p for p in grads if named(p, NONZERO[case["arch"]])]
    assert all(any(named(p, (n,)) for p in live)
               for n in NONZERO[case["arch"]])
    assert all(bool(grads[p].any()) for p in live), [
        p for p in live if not grads[p].any()]
    assert ops.launch_counts()["flash_attention"] == 0   # CPU: plain only


def test_remat_on_equals_remat_off(case):
    loss0, _, g0 = port_grads(case, remat=False)
    loss1, _, g1 = port_grads(case, remat=True)
    assert abs(loss0 - loss1) <= 1e-6 * abs(loss0)
    for path, g in g0.items():
        assert rel(g1[path], g.numpy()) <= 1e-6, path


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match(arch):
    rcfg, cfg = configs(arch)
    jopt = jsteps.default_optimizer(rcfg, lr=LR, total_steps=10)
    popt = steps.default_optimizer(cfg, lr=LR, total_steps=10)
    assert popt.name == ("adafactor" if arch.startswith("deepseek")
                         else "adamw")
    params = ref_init(jax.random.PRNGKey(0), rcfg)
    js = jsteps.TrainState(params=params, opt_state=jopt.init(params),
                           mtl=ref_mtl_state(rcfg.d_model, rcfg.mtl),
                           step=jnp.zeros((), jnp.int32))
    init = {k: np.array(v) for k, v in flat(js).items()
            if k.startswith("params.")}
    ps = train_state_from_numpy(cfg, flat(js), popt, "cpu")
    jstep = jax.jit(jsteps.make_train_step(rcfg, jopt, remat=True))
    pstep = steps.make_train_step(cfg, popt, remat=True)
    it = train.batches_for(cfg, SEQ, BATCH, seed=1)
    names = ("loss", "lm_loss", "probe_loss", "aux_loss") + (
        ("mtp_loss",) if cfg.mtp else ())
    for i in range(STEPS):
        b = next(it)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pstep(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        assert ps.step == i + 1
        assert ("mtp_loss" in pm) == ("mtp_loss" in jm) == cfg.mtp
        for k in names:
            assert abs(float(pm[k]) - float(jm[k])) <= RTOL * abs(
                float(jm["loss"])), (i, k)
        assert float(pm["mtl_active_frac"]) == float(jm["mtl_active_frac"])
        assert float(pm["mtl_mean_staleness"]) == float(
            jm["mtl_mean_staleness"])
        ring = rel(ps.mtl.ring, np.asarray(js.mtl.ring))
        assert ring <= (RTOL if i == 0 else RING_DRIFT_RTOL), (i, ring)
    want, got = flat(js), train_state_to_numpy(ps)
    assert set(got) == set(want)
    for k, w0 in init.items():
        d_want = np.asarray(want[k]) - w0
        d_got = got[k] - w0
        assert np.abs(d_want).max() > 0, k
        assert np.linalg.norm(d_got - d_want) <= UPDATE_RTOL * np.linalg.norm(
            d_want), k
        if popt.name == "adafactor":
            assert np.abs(d_got - d_want).max() <= ADAFACTOR_UPDATE_RTOL \
                * np.abs(d_want).max(), k
        else:
            assert np.abs(d_got - d_want).max() <= 2 * LR * STEPS, k
    for k in ("mtl.ptr", "mtl.step", "mtl.delay_buf", "mtl.delay_cnt",
              "step"):
        np.testing.assert_array_equal(got[k], want[k])


def test_expert_without_tokens_gets_a_zero_gradient():
    """The MoE FFN's gradient against `jax.grad` of the reference's dropless
    `moe_dense` when one expert wins no token (inputs positive, its router
    column negative): that expert's weights take an exact zero gradient in
    both, and every other leaf and the input match to 1e-5 of scale."""
    _, cfg = configs("deepseek-v3-671b")
    rcfg = ref_config("deepseek-v3-671b").reduced()
    rng = np.random.default_rng(4)
    d, m = cfg.d_model, cfg.moe
    p = {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
         for k, s in moe.param_shapes(cfg).items()}
    p["router"][:, 3] = -np.abs(p["router"][:, 3]) - 0.1
    x = np.abs(rng.standard_normal((2, 24, d))).astype(np.float32)
    dy = rng.standard_normal((2, 24, d)).astype(np.float32)

    def jloss(pp, xx):
        y, aux = jmoe.moe_dense(pp, xx, rcfg)
        return jnp.sum(y * dy) + aux
    jp, jx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    _, idx, _ = moe._router(tp["router"], tx.reshape(-1, d), m)
    assert 3 not in idx.unique().tolist()
    y, aux = moe.moe_dense(tp, tx, cfg)
    (torch.sum(y * torch.from_numpy(dy)) + aux).backward()
    for name in ("w_in", "w_gate", "w_out"):
        assert not tp[name].grad[3].any() and not np.asarray(
            jp[name])[3].any(), name
        assert tp[name].grad[:3].abs().amax(dim=(1, 2)).min() > 0, name
    for k, g in jp.items():
        assert rel(tp[k].grad, g) <= RTOL, k
    assert rel(tx.grad, jx) <= RTOL


def test_mla_attention_gradient_drops_the_padded_v_columns():
    """MLA's attention call under autograd (`_mha_mixed_dims`: v zero-padded
    from 32 to q's and k's 48 columns, the output's padded columns sliced
    off) against `jax.grad` of the reference's: q, k and v's gradients to
    1e-5 of scale, and the padded v's gradient exactly 0 past column 32."""
    rng = np.random.default_rng(5)
    q, k = (rng.standard_normal((2, 20, 4, 48)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 20, 4, 32)).astype(np.float32)
    do = rng.standard_normal((2, 20, 4, 32)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(jattn._mha_mixed_dims(*a, causal=True) * do)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (q, k, v)))
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    padded = []
    mha = attention.mha

    def spy(q_, k_, v_, **kw):
        v_.retain_grad()
        padded.append(v_)
        return mha(q_, k_, v_, **kw)
    attention.mha = spy
    try:
        out = attention._mha_mixed_dims(*leaves, causal=True)
    finally:
        attention.mha = mha
    assert out.shape == (2, 20, 4, 32)
    (out * torch.from_numpy(do)).sum().backward()
    (v_p,) = padded
    assert v_p.shape[-1] == 48 and not v_p.grad[..., 32:].any()
    assert torch.equal(v_p.grad[..., :32], leaves[2].grad)
    for leaf, g in zip(leaves, jg):
        assert rel(leaf.grad, g) <= RTOL


@pytest.mark.parametrize("arch,periods,fwd,bwd", [
    ("dbrx-132b", 1, 2, 1), ("dbrx-132b", 2, 4, 2),
    ("deepseek-v3-671b", 0, 7, 4)])
def test_chip_smoke_counts_the_mtp_block_outside_remat(arch, periods, fwd,
                                                       bwd):
    """A train step's attention launches: each layer's call forward twice
    (once more under remat) and backward once, and deepseek's MTP block,
    outside remat, once each."""
    cs = chip_smoke()
    cfg = cs.train_depth_cut(get_config(arch), periods)
    assert cs.train_launches(cfg) == (fwd, bwd)


@pytest.mark.parametrize("arch,phase", [("dbrx-132b", 37),
                                        ("deepseek-v3-671b", 38)])
def test_chip_smoke_training_spec_names_live_leaves(arch, phase):
    """Phases 37-38 train under Adafactor at their depth cut, and every
    leaf name whose gradient they hold non-zero is a leaf of that cut
    ("mtp." a prefix), so the check cannot pass by naming nothing."""
    cs = chip_smoke()
    spec = cs.TRAINED[arch]
    cfg = cs.train_depth_cut(get_config(arch), cs.TRAIN_PERIODS[arch])
    paths = list(transformer.param_shapes(cfg))
    assert spec["phase"] == phase and spec["optimizer"] == "adafactor"
    for name in spec["nonzero"]:
        assert any(cs.named(p, (name,)) for p in paths), name
    assert cs.named("mtp.block.attn.wq_a", ("mtp.",))
    assert not cs.named("group0.b0.attn.wq_a", ("mtp.",))
    assert cs.named("group0.b0.moe.w_in", ("moe.w_in",))
    assert not cs.named("group0.b0.moe.w_in", ("w_in_x",))
