"""zamba2-7b and llama-3.2-vision-11b training in the port against the
reference's, on the CPU, at their reduced configs (float32):

- zamba2-7b with 2 periods (13 layers = 2 x (5 mamba + 1 shared_attn) + 1
  mamba), so the weight-tied shared block runs at two invocations and its
  gradient is summed over them; Mamba-2 chunk 16 at sequence 40, so the
  SSD's ragged tail (8 tokens padded with dt = 0) runs under grad;
- llama-3.2-vision-11b (4 attn + 1 cross, 16 vision embeddings), and in
  the gradient tests its GQA variant (4 heads, 2 kv).

The reference's inert leaves (the cross gate, the LoRA b matrices, the
SSD's A_log, D, dt_bias and conv bias) are drawn as
tests/test_torch_hybrid_archs.py's `perturb` draws them, so the cross
block's xattn leaves and the LoRA a matrices get a gradient that is not
zero; the weights cross by `interop`.  The batches are `batches_for`'s
(the vlm's carry its vision embeddings) and the reference runs jitted.

Tolerances: `forward`'s loss to 1e-6 relative; `pooled` and every leaf's
gradient to 1e-5 of its scale (max |diff| over max |grad|; float32 matmuls
summed in another order), except the SSD's per-head A_log and dt_bias at
2e-5: each is a sum over B x L positions of terms of both signs, and on
this CPU the port's and the reference's float32 gradients each read up to
9.3e-6 and 7.9e-6 of scale from a float64 run of the same SSD, 1.13e-5
from each other (at two batch seeds).  Three train steps: the loss and
the LM loss to 1e-5 relative, the params within 2 lr a step, the head's
draws and counters bitwise, as tests/test_torch_train.py holds gemma2-2b;
the head's ring to 1e-5 of its scale after step 0 (the same params in
both).  Adam's update is lr times about sign(g) early on, so an element
whose gradient is near 0 (zamba2's out_proj at 4e-10, the embedding) lands
up to 2 lr away (seen 2.46 lr after 3 steps), and the later steps' pooled
states move with it: there zamba2's probe loss (0.057) moved by 1.3e-6
(2.3e-5 of it, 2e-7 of the step's loss) and its ring by 4.1e-5 of its
scale, so the probe loss is held to 1e-5 of the step's loss and the ring
after step 0 to 1e-4.
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
from repro.models import init_params as ref_init  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MLACfg, MoECfg  # noqa: E402
from repro_torch.interop import (lm_params_from_numpy,  # noqa: E402
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.kernels import flash_attention_bwd as k_bwd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim.optimizers import tree_items  # noqa: E402
from test_torch_hybrid_archs import (chip_smoke, flat, perturb,  # noqa: E402
                                     rel)

RTOL = 1e-5
RING_DRIFT_RTOL = 1e-4
SSD_SUM_RTOL = 2e-5
SSD_SUM_LEAVES = ("mamba.A_log", "mamba.dt_bias")
SEQ, BATCH, STEPS, LR = 40, 2, 3, 1e-3
ARCHS = ("zamba2-7b", "llama-3.2-vision-11b")
PERIODS = {"zamba2-7b": 2, "llama-3.2-vision-11b": 1}
# (arch, (heads, kv heads) or None for the reduced config's)
CASES = [("zamba2-7b", None), ("llama-3.2-vision-11b", None),
         ("llama-3.2-vision-11b", (4, 2))]
IDS = [f"{a}-{'gqa' if h else 'base'}" for a, h in CASES]
# the leaves the reference's init leaves without a gradient, and the
# top-level tied block's, that must get one here
WOKEN = {"zamba2-7b": ("lora_q_a", "lora_q_b", "lora_o_a", "lora_o_b",
                       "shared_attn.attn.wq", "shared_attn.ffn.w_in"),
         "llama-3.2-vision-11b": ("xattn.wq", "xattn.wk", "xattn.wv",
                                  "xattn.wo", "xattn.gate")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread a worker: the suite runs this file beside five
    other workers on the same cores, where torch's default of a thread a
    core oversubscribes them (the file took ~9x its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cut(cfg, periods: int):
    """cfg with `periods` periods, the head and tail blocks kept."""
    return dataclasses.replace(
        cfg, num_periods=periods, num_layers=len(cfg.head_blocks)
        + len(cfg.period) * periods + len(cfg.tail_blocks))


def configs(arch: str, heads=None):
    changes = {} if heads is None else dict(num_heads=heads[0],
                                            num_kv_heads=heads[1])
    return tuple(cut(dataclasses.replace(c.reduced(), **changes),
                     PERIODS[arch])
                 for c in (ref_config(arch), get_config(arch)))


def tol(path: str) -> float:
    return SSD_SUM_RTOL if path.endswith(SSD_SUM_LEAVES) else RTOL


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """The reference's woken weights, a batch, and its jitted loss and
    gradient of loss + 0.1 |pooled|^2 (so `pooled` has a gradient of its
    own)."""
    arch, heads = request.param
    rcfg, cfg = configs(arch, heads)
    params = perturb(ref_init(jax.random.PRNGKey(0), rcfg), 1)
    batch = next(train.batches_for(cfg, SEQ, BATCH, seed=3))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        loss, m = jtf.forward(p, jb, rcfg)
        return loss + 0.1 * jnp.sum(m["pooled"] ** 2), (loss, m)

    (_, (jl, jm)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    return dict(arch=arch, rcfg=rcfg, cfg=cfg, params=params, batch=batch,
                loss=float(jl), pooled=np.asarray(jm["pooled"]),
                grads=flat(jg))


def port_grads(case, remat: bool) -> tuple:
    model = lm_params_from_numpy(case["cfg"], flat(case["params"]), "cpu")
    model.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    loss, m = transformer.forward(model, tb, case["cfg"], remat=remat)
    (loss + 0.1 * torch.sum(m["pooled"] ** 2)).backward()
    return loss.item(), m, {".".join(p): leaf.grad
                            for p, leaf in tree_items(model.tree())}


def test_forward_loss_pooled_and_grads_match(case):
    ops.reset_launch_counts()
    loss, m, grads = port_grads(case, remat=True)
    assert abs(loss - case["loss"]) <= 1e-6 * abs(case["loss"])
    assert rel(m["pooled"], case["pooled"]) <= RTOL
    assert set(grads) == set(case["grads"])
    for path, g in grads.items():
        assert g is not None and g.dtype == transformer.param_dtypes(
            case["cfg"])[path], path
        assert rel(g, case["grads"][path]) <= tol(path), path
    woken = [p for p in grads if any(p.endswith(w) or f".{w}" in p
                                     for w in WOKEN[case["arch"]])]
    assert woken and all(bool(grads[p].any()) for p in woken), woken
    assert ops.launch_counts()["flash_attention"] == 0   # CPU: plain only


def test_remat_on_equals_remat_off(case):
    loss0, _, g0 = port_grads(case, remat=False)
    loss1, _, g1 = port_grads(case, remat=True)
    assert abs(loss0 - loss1) <= 1e-6 * abs(loss0)
    for path, g in g0.items():
        assert rel(g1[path], g.numpy()) <= 1e-6, path


def test_tied_block_gradient_sums_over_its_invocations():
    """Two shared_attn invocations with one tied copy of the shared params
    give each shared leaf the sum of the gradients that two untied copies
    get, and each invocation's LoRA leaves their own."""
    _, cfg = configs("zamba2-7b")
    model = transformer.init_params(cfg, seed=0, device="cpu")
    tree = model.tree()
    gen = torch.Generator().manual_seed(0)
    block = tree["group0"][f"b{len(cfg.period) - 1}"]
    lora = [{k: {n: t[i].detach().clone() for n, t in v.items()}
             if isinstance(v, dict) else
             0.05 * torch.randn(v.shape[1:], generator=gen)
             for k, v in block.items()} for i in range(2)]
    x = torch.randn(2, 24, cfg.d_model, generator=gen)

    def run(shared_copies):
        for p in [*lora, *shared_copies]:
            for _, leaf in tree_items(p):
                leaf.requires_grad_(True)
                leaf.grad = None
        h = x
        for p, sh in zip(lora, shared_copies):
            h, _ = transformer.apply_block(
                "shared_attn", p, h, cfg, transformer.Extras(shared_attn=sh))
        torch.sum(h ** 2).backward()

    def copy():
        return {k: {n: t.detach().clone() for n, t in v.items()}
                for k, v in tree["shared_attn"].items()}
    tied = copy()
    run([tied, tied])
    tied_grads = {p: t.grad.clone() for p, t in tree_items(tied)}
    lora_tied = [{k: t.grad.clone() for k, t in p.items()
                  if k.startswith("lora")} for p in lora]
    untied = [copy(), copy()]
    run(untied)
    for (p, a), (_, b) in zip(tree_items(untied[0]), tree_items(untied[1])):
        assert bool(a.grad.any()) and bool(b.grad.any()), p
        assert rel(a.grad + b.grad, tied_grads[p].numpy()) <= 1e-6, p
    for p, want in zip(lora, lora_tied):
        for k, g in want.items():
            assert bool(g.any()) and rel(p[k].grad, g.numpy()) <= 1e-6, k


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match(arch):
    rcfg, cfg = configs(arch)
    jopt = jsteps.default_optimizer(rcfg, lr=LR, total_steps=10)
    popt = steps.default_optimizer(cfg, lr=LR, total_steps=10)
    params = perturb(ref_init(jax.random.PRNGKey(0), rcfg), 1)
    js = jsteps.TrainState(params=params, opt_state=jopt.init(params),
                           mtl=ref_mtl_state(rcfg.d_model, rcfg.mtl),
                           step=jnp.zeros((), jnp.int32))
    ps = train_state_from_numpy(cfg, flat(js), popt, "cpu")
    jstep = jax.jit(jsteps.make_train_step(rcfg, jopt, remat=True))
    pstep = steps.make_train_step(cfg, popt, remat=True)
    it = train.batches_for(cfg, SEQ, BATCH, seed=1)
    ops.reset_launch_counts()
    for i in range(STEPS):
        b = next(it)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pstep(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        assert ps.step == i + 1
        for k, of in (("loss", "loss"), ("lm_loss", "lm_loss"),
                      ("probe_loss", "loss")):
            assert abs(float(pm[k]) - float(jm[k])) <= 1e-5 * abs(
                float(jm[of])), (i, k)
        assert float(pm["mtl_active_frac"]) == float(jm["mtl_active_frac"])
        assert float(pm["mtl_mean_staleness"]) == float(
            jm["mtl_mean_staleness"])
        ring = rel(ps.mtl.ring, np.asarray(js.mtl.ring))
        assert ring <= (RTOL if i == 0 else RING_DRIFT_RTOL), (i, ring)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    want, got = flat(js), train_state_to_numpy(ps)
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("params."):
            assert np.abs(got[k] - w).max() <= 2 * LR * STEPS, k
    for k in ("mtl.ptr", "mtl.step", "mtl.delay_buf", "mtl.delay_cnt",
              "step"):
        np.testing.assert_array_equal(got[k], want[k])


def test_bf16_step_keeps_the_float32_leaves_and_crosses_to_numpy():
    """A bf16 zamba2-7b (reduced) takes a train step on the CPU:
    the SSD's A_log, D and dt_bias stay float32 (AdamW casts its float32
    master back to each leaf's dtype) and move; the whole state, the
    top-level shared_attn tree and the stacked LoRA leaves with it,
    crosses to numpy and back bit for bit."""
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                              dtype="bfloat16")
    opt = steps.default_optimizer(cfg, lr=LR, total_steps=10)
    state = steps.init_train_state(cfg, opt, seed=0, device="cpu")
    chip_smoke().wake_inert_leaves(state.params, 0)
    before = {p: t.detach().clone() for p, t in
              state.params.state_dict().items()}
    batch = next(train.batches_for(cfg, 16, BATCH, seed=1))
    state, m = steps.make_train_step(cfg, opt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(m["loss"]))
    dtypes = transformer.param_dtypes(cfg)
    after = state.params.state_dict()
    for p, t in after.items():
        assert t.dtype == dtypes[p], p
        if p.endswith(("A_log", ".D", "dt_bias", "lora_q_a", "lora_o_b")):
            assert not torch.equal(t, before[p]), p
    assert {t.dtype for _, t in tree_items(state.opt_state)} == \
        {torch.float32}
    host = train_state_to_numpy(state)
    assert {"params.shared_attn.attn.wq", "params.group0.b5.lora_q_a",
            "opt_state.master.shared_attn.ffn.w_out",
            "opt_state.nu.group0.b5.lora_o_b",
            "opt_state.mu.group1.b0.mamba.A_log"} <= set(host)
    back = train_state_from_numpy(cfg, host, opt, "cpu")
    for p, t in back.params.state_dict().items():
        assert t.dtype == dtypes[p] and torch.equal(t, after[p]), p
    again = train_state_to_numpy(back)
    assert set(again) == set(host)
    for k, v in host.items():
        np.testing.assert_array_equal(again[k], v)


def test_ssd_gradient_stays_finite_where_the_decay_overflows():
    """Long decays (dt 0.6, A = -e: the decays of a 64-token chunk sum to
    -104) overflow exp (past 88) above the diagonal of the within-chunk
    decay, as zamba2-7b's do at its published widths on the card.  The
    port masks before the exp: its output is the reference's, and its
    gradients are finite (the reference's dt and A_log gradients are not)
    and match the token-by-token recurrence's in float64 (h_t = exp(dt_t
    a) h_t-1 + dt_t x_t B_t, y_t = C_t . h_t + D x_t) to 1e-4 of scale
    (seen 1.1e-5 for A_log: the chunked form's float32 log-decays of ~100
    keep ~1e-5 of their differences)."""
    from repro.models.ssm import _ssd_chunked as ref_ssd
    from repro_torch.models import ssm
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 64, 4, 8)).astype(np.float32)
    dt = np.full((1, 64, 4), 0.6, np.float32)
    a_log = np.ones((4,), np.float32)
    bm, cm = (rng.standard_normal((1, 64, 1, 8)).astype(np.float32)
              for _ in range(2))
    d = np.ones((4,), np.float32)

    def jloss(*a):
        return jnp.sum(ref_ssd(*a, jnp.asarray(bm), jnp.asarray(cm),
                               jnp.asarray(d), 64)[0])
    want_y = ref_ssd(*(jnp.asarray(t) for t in (x, dt, a_log, bm, cm, d)),
                     64)[0]
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (x, dt, a_log)))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jg)

    leaves = [torch.tensor(t, requires_grad=True) for t in (x, dt, a_log)]
    y, _ = ssm._ssd_chunked(*leaves, torch.tensor(bm), torch.tensor(cm),
                            torch.tensor(d), 64)
    y.sum().backward()
    assert rel(y, want_y) <= RTOL

    xs, dts, als = (torch.tensor(t, dtype=torch.float64, requires_grad=True)
                    for t in (x, dt, a_log))
    b64, c64 = (torch.tensor(t[0, :, 0], dtype=torch.float64)
                for t in (bm, cm))
    a, h, total = -torch.exp(als), torch.zeros(4, 8, 8, dtype=torch.float64), 0
    for t in range(64):
        h = torch.exp(dts[0, t] * a)[:, None, None] * h \
            + (dts[0, t, :, None] * xs[0, t])[..., None] * b64[t]
        total = total + torch.sum(h @ c64[t] + xs[0, t])
    total.backward()
    for leaf, w in zip(leaves, (xs, dts, als)):
        assert bool(torch.isfinite(leaf.grad).all())
        assert rel(leaf.grad, w.grad.numpy()) <= 1e-4


@pytest.mark.parametrize("change", [
    dict(moe=MoECfg(num_experts=4, top_k=2, d_expert=128)),
    dict(mla=MLACfg()), dict(kv_cache_dtype="int8")],
    ids=["moe", "mla", "int8-cache"])
def test_training_still_refuses_what_is_not_ported(change):
    """MoE and MLA train since item 11(l): the check takes them and the
    train step takes a step with a finite loss.  The int8 cache (item
    11(f)) is a serving setting: training builds no cache, so an int8
    config's step gives losses and parameters bitwise its model-dtype
    twin's."""
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), **change)
    transformer.require_ported(cfg, training=True)
    batch = next(train.batches_for(cfg, 16, BATCH, seed=1))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def one_step(c):
        opt = steps.default_optimizer(c)
        state = steps.init_train_state(c, opt, seed=0, device="cpu")
        state, m = steps.make_train_step(c, opt)(state, batch)
        return state, m

    state, m = one_step(cfg)
    assert np.isfinite(float(m["loss"]))
    if "kv_cache_dtype" not in change:
        return
    twin, tm = one_step(dataclasses.replace(cfg, kv_cache_dtype="model"))
    for k in ("loss", "lm_loss", "probe_loss"):
        assert float(m[k]) == float(tm[k]), k
    for (path, a), (_, b) in zip(tree_items(state.params.tree()),
                                 tree_items(twin.params.tree()),
                                 strict=True):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_on_the_cpu(arch, capsys):
    log = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "24",
                      "--log-every", "1"])
    assert [r["step"] for r in log] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert f"{arch}-reduced" in capsys.readouterr().out


@pytest.mark.parametrize("arch,periods,fwd,bwd", [
    ("zamba2-7b", 6, 12, 6), ("llama-3.2-vision-11b", 2, 24, 12),
    ("gemma2-2b", None, 52, 26), ("hubert-xlarge", None, 96, 48)])
def test_chip_smoke_counts_a_train_step_by_block_kind(arch, periods, fwd,
                                                      bwd):
    """A train step's attention launches: every call forward twice (once
    more under remat) and backward once; zamba2's one shared_attn call a
    period, llama's four self calls and a cross layer's two."""
    cs = chip_smoke()
    cfg = get_config(arch)
    if periods:
        cfg = cs.train_depth_cut(cfg, periods)
    assert cs.train_launches(cfg) == (fwd, bwd)


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_depth_cut_keeps_the_published_widths(arch):
    """The card's cut has the published config's every leaf and per-layer
    shape: a period's stacked leaves differ in their lead only, and one
    period of the cut gives the published config's one-period shapes."""
    cs = chip_smoke()
    full = get_config(arch)
    periods = cs.TRAIN_PERIODS[arch]
    cfg = cs.train_depth_cut(full, periods)
    assert 1 <= periods < full.num_periods
    assert cfg.num_periods == periods and cfg.num_layers == len(
        cfg.layer_kinds) == full.num_layers - len(full.period) * (
            full.num_periods - periods)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (full.d_model, full.num_heads,
                                          full.num_kv_heads, full.head_dim,
                                          full.d_ff, full.vocab_size)
    got, want = (transformer.param_shapes(c) for c in (cfg, full))
    assert set(got) == set(want)
    gi = [g.period for g in transformer.scan_groups(full)].index(
        tuple(full.period))
    for k, v in want.items():
        if k.startswith(f"group{gi}."):
            assert v[0] == full.num_periods and got[k] == (periods,) + v[1:], k
        else:
            assert got[k] == v, k
    assert cs.train_depth_cut(full, full.num_periods) == full


@pytest.mark.parametrize("label,b,sq,skv,h,hkv,hd", [
    ("zamba2 shared attention", 2, 2048, 2048, 32, 32, 112),
    ("llama self-attention", 2, 2048, 2048, 32, 8, 128),
    ("llama cross-attention", 2, 2048, 1601, 32, 8, 128)])
def test_backward_route_takes_every_training_call(label, b, sq, skv, h, hkv,
                                                  hd):
    """The bf16 training calls of both archs take the backward's sm90
    route (zamba2's hd 112 at 128 columns), never simt."""
    assert k_bwd.route(torch.bfloat16, b, sq, skv, h, hkv, hd, skv) == "sm90"
    assert k_bwd.route(torch.float32, b, sq, skv, h, hkv, hd, skv) == "simt"
