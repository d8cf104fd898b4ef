"""The int8 KV cache (ROADMAP item 11(f)) in the port against the
reference, on the CPU, at the reduced configs (float32).

`quantize_kv` is one float32 division and a round-half-even: the scales
are held bitwise and the int8 values bitwise, or one step apart only
where the quotient lies within one float32 ulp of a .5 boundary.

The reference's decode is right only on a mesh: its mesh-less
`attn_decode` writes the new entry without quantizing it and reads the
cache without its scales (ROADMAP Queue 3).  So the port is held to
`decode_step(..., ctx)` under a 1 x 1 mesh, which takes
`attn_decode_sharded`'s dequantizing branch.  granite-8b, gemma2-2b (a
12-token prompt, inside the reduced window of 64, where the two ring
layouts agree), zamba2-7b (the shared attention's cache) and
llama-3.2-vision-11b (the self cache int8, `CrossKV` float32) run B 2, a
12-token prompt and 4 teacher-forced decode steps, their inert leaves
drawn from numpy:

- the prefill cache: int8 within one step of JAX's, scales at 1e-5
  relative; prefill logits bitwise the port's model-dtype run (prefill
  attends over the float k and v) and at 1e-5 of scale JAX's;
- decode from the cache JAX's prefill made, at 1e-4 of max |logits|;
  from each package's own prefill at 2e-3;
- the int8 run's distance from the model-dtype run, as a share of max
  |logits|, within 0.5-2x of the reference's own at every decode step
  (a decode that dropped the scales reads ~100 %).

dbrx-132b's whole `decode_step` raises under the 1 x 1 mesh in the
reference (a sharding error of its MoE), so its attention layer is held
alone.  deepseek-v3-671b's MLA keeps its latent cache in the model dtype
whatever the setting, as the reference's does.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models import serving as ref_serving  # noqa: E402
from repro.models.moe import ParallelCtx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import (kv_cache_from_numpy,  # noqa: E402
                                 kv_cache_to_numpy, lm_params_from_numpy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM, attention, init_params  # noqa: E402
from repro_torch.models.serving import decode_step, init_cache, prefill  # noqa: E402,E501

ARCHS = ("granite-8b", "gemma2-2b", "zamba2-7b", "llama-3.2-vision-11b")
B, PROMPT, GEN = 2, 12, 4
DRAWS = {"gate": lambda rng, s: rng.uniform(0.5, 1.5, s),
         "lora_q_b": lambda rng, s: 0.02 * rng.standard_normal(s),
         "lora_o_b": lambda rng, s: 0.02 * rng.standard_normal(s)}


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


def mesh_ctx() -> ParallelCtx:
    return ParallelCtx(mesh=jax.make_mesh((1, 1), ("data", "model")),
                       data_axes=("data",), model_axis="model")


def int8(cfg):
    return dataclasses.replace(cfg, kv_cache_dtype="int8")


def ulp_ties(t: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Where t / scale lies within one float32 ulp of a .5 boundary."""
    qt = t.astype(np.float32) / scale[..., None]
    frac = np.abs(np.abs(qt) - np.floor(np.abs(qt)) - np.float32(0.5))
    return frac <= np.spacing(np.abs(qt).astype(np.float32))


def steps_apart(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got.astype(np.int32) - want.astype(np.int32))


@pytest.mark.parametrize("shape,kind", [
    ((2, 7, 3, 64), "normal"), ((1, 5, 2, 128), "wide"),
    ((3, 4, 1, 16), "zero-row"), ((2, 3, 2, 32), "clip")])
def test_quantize_kv_matches_the_reference(shape, kind):
    rng = np.random.default_rng(len(kind))
    t = rng.standard_normal(shape).astype(np.float32)
    if kind == "wide":
        t *= np.float32(1e3) * rng.random(shape[:-1] + (1,),
                                          dtype=np.float32)
    if kind == "zero-row":
        t[0, 1] = 0.0
        t[1, 2, 0, :5] = 0.0
    if kind == "clip":
        # each row's absmax at +-127 scale steps, others at exact halves
        t = (np.round(t * 20) / 2).astype(np.float32)
        t[..., 0] = np.float32(127.0)
        t[..., 1] = np.float32(-127.0)
    want_q, want_s = (np.asarray(a) for a in
                      ref_attn.quantize_kv(jnp.asarray(t)))
    got_q, got_s = (a.numpy() for a in
                    attention.quantize_kv(torch.from_numpy(t)))
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_s.view(np.int32),
                                  want_s.view(np.int32))
    apart = steps_apart(got_q, want_q)
    ties = ulp_ties(t, want_s)
    assert apart.max() <= 1 and not (apart & ~ties).any()
    print(f"{kind}: {int(apart.sum())} int8 values one step apart, all "
          f"within one ulp of a .5 boundary ({int(ties.sum())} such)")
    if kind == "zero-row":
        assert (got_q[0, 1] == 0).all()
        np.testing.assert_array_equal(got_s[0, 1],
                                      np.float32(1e-8) / np.float32(127))
    if kind == "clip":
        assert (got_q[..., 0] == 127).all() and (got_q[..., 1] == -127).all()
    back = attention.dequantize_kv(torch.from_numpy(got_q),
                                   torch.from_numpy(got_s), torch.float32)
    assert np.abs(back.numpy() - t).max() <= 0.5 * got_s.max() * 1.0001


def perturb(params, seed: int):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        draw = DRAWS.get(_key(path[-1]))
        return x if draw is None else jnp.asarray(draw(rng, x.shape),
                                                  x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=None)
def runs(arch: str) -> dict:
    """Prefill and GEN teacher-forced decode steps of `arch`'s reduced
    config in both packages, model dtype and int8, on the same weights
    and tokens; the port's int8 decode also from JAX's int8 prefill."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    params = perturb(ref_init(jax.random.PRNGKey(0), rcfg), 1)
    weights = flat(params)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (B, PROMPT + GEN))
    vis = serve.make_vision_embeds(cfg, B, 3)
    s_max = PROMPT + GEN
    ctx = mesh_ctx()
    out = {"cfg": cfg}
    for name, rc, pc in (("model", rcfg, cfg),
                         ("int8", int8(rcfg), int8(cfg))):
        batch = {"tokens": jnp.asarray(toks[:, :PROMPT], jnp.int32)}
        if vis is not None:
            batch["vision_embeds"] = jnp.asarray(vis)
        jpre = jax.jit(lambda p, bt, _c=rc: ref_serving.prefill(
            p, bt, _c, s_max=s_max, remat=False))
        jdec = jax.jit(lambda p, c, t, pos, _c=rc: ref_serving.decode_step(
            p, c, t, pos, _c, ctx))
        lg, rcache = jpre(params, batch)
        jlog, jcache0 = [np.asarray(lg)], flat(rcache)
        for i in range(GEN):
            lg, rcache = jdec(params, rcache, jnp.asarray(
                toks[:, PROMPT + i:PROMPT + i + 1], jnp.int32),
                jnp.asarray(PROMPT + i, jnp.int32))
            jlog.append(np.asarray(lg))

        model = lm_params_from_numpy(pc, weights, "cpu")
        pvis = None if vis is None else torch.as_tensor(vis)
        tree = model.tree()

        def port_decode(cache):
            logs = []
            with torch.inference_mode():
                for i in range(GEN):
                    lg, cache = decode_step(tree, cache, torch.as_tensor(
                        toks[:, PROMPT + i:PROMPT + i + 1]), PROMPT + i, pc)
                    logs.append(lg)
            return logs

        with torch.inference_mode():
            plg, pcache = prefill(tree, torch.as_tensor(toks[:, :PROMPT]),
                                  pc, s_max=s_max, vision_embeds=pvis)
        pcache0 = kv_cache_to_numpy(pcache)
        plog = [plg] + port_decode(pcache)
        carried = port_decode(kv_cache_from_numpy(pc, jcache0, "cpu"))
        out[name] = dict(jlog=jlog, jcache=jcache0, plog=plog,
                         pcache=pcache0, carried=carried)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_matches_the_reference(arch):
    r = runs(arch)
    got, want = r["int8"]["pcache"], r["int8"]["jcache"]
    assert set(got) == set(want)
    scales = [k for k in want if k.endswith("_scale")]
    assert scales and all(want[k[:-len("_scale")]].dtype == np.int8
                          for k in scales)
    apart = 0
    for k, w in want.items():
        if w.dtype == np.int8:
            d = steps_apart(got[k].astype(np.int8), w)
            assert d.max() <= 1, k
            apart += int(d.sum())
        elif k.endswith("_scale"):
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=0)
        else:           # CrossKV and the SSM states stay float32
            assert w.dtype == np.float32 and rel(got[k], w) <= 1e-5, k
    print(f"{arch}: {apart} int8 cache values one step from JAX's")
    assert torch.equal(r["int8"]["plog"][0], r["model"]["plog"][0])
    assert rel(r["int8"]["plog"][0], r["int8"]["jlog"][0]) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_references_cache(arch):
    r = runs(arch)["int8"]
    errs = [rel(g, w) for g, w in zip(r["carried"], r["jlog"][1:],
                                      strict=True)]
    assert max(errs) <= 1e-4, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tracks_the_model_dtype_as_the_reference_does(arch):
    r = runs(arch)
    q, m = r["int8"], r["model"]
    errs = [rel(g, w) for g, w in zip(q["plog"], q["jlog"], strict=True)]
    assert max(errs) <= 2e-3, errs
    port_d = [rel(g, w) for g, w in zip(q["plog"][1:], m["plog"][1:])]
    ref_d = [rel(g, w) for g, w in zip(q["jlog"][1:], m["jlog"][1:])]
    print(f"{arch}: int8 against the model dtype, port {port_d}, "
          f"reference {ref_d}")
    for p, w in zip(port_d, ref_d, strict=True):
        assert 0.5 * w <= p <= 2.0 * w, (port_d, ref_d)
    assert max(ref_d) < 0.05


def test_dbrx_attention_layer_matches_the_sharded_decode():
    """dbrx-132b's attention layer: prefill's int8 cache within one step of
    the reference's, then one decode step of the port's `attn_decode`
    against the reference's `attn_decode_sharded` under the 1 x 1 mesh:
    from the reference's cache at 1e-5 of scale, and from the port's own
    at 2e-3."""
    rcfg = int8(ref_config("dbrx-132b").reduced())
    cfg = int8(get_config("dbrx-132b").reduced())
    p = ref_attn.init_attn(jax.random.PRNGKey(3), rcfg, jnp.float32)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rng = np.random.default_rng(5)
    s, s_max = 10, 16
    x = 0.5 * rng.standard_normal((B, s + 1, cfg.d_model)).astype(np.float32)
    _, rc = ref_attn.attn_forward(p, jnp.asarray(x[:, :s]), rcfg,
                                  return_cache=True, cache_len=s_max)
    carried = attention.KVCache(*(torch.from_numpy(np.array(a)) for a in rc))
    want, rc = ref_attn.attn_decode_sharded(
        p, jnp.asarray(x[:, s:]), rc, jnp.asarray(s, jnp.int32), rcfg,
        mesh_ctx())
    with torch.inference_mode():
        _, pc = attention.attn_forward(pt, torch.from_numpy(x[:, :s]), cfg,
                                       return_cache=True, cache_len=s_max)
        for a, w in zip(pc, carried, strict=True):
            if w.dtype == torch.int8:
                assert steps_apart(a.numpy(), w.numpy()).max() <= 1
        own, pc = attention.attn_decode(pt, torch.from_numpy(x[:, s:]), pc,
                                        s, cfg)
        got, carried = attention.attn_decode(
            pt, torch.from_numpy(x[:, s:]), carried, s, cfg)
    assert pc.k.dtype == torch.int8 and pc.k_scale.dtype == torch.float32
    assert rel(got, want) <= 1e-5
    assert rel(own, want) <= 2e-3
    for a, w in zip(carried, rc, strict=True):
        if w.dtype == jnp.int8:
            assert steps_apart(a.numpy(), np.asarray(w)).max() <= 1
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=0)


def test_deepseek_int8_config_serves_as_its_model_dtype_twin():
    """MLA ignores kv_cache_dtype, as the reference's does: the int8
    config's prefill, cache and decode are bitwise the model-dtype one's."""
    cfg = get_config("deepseek-v3-671b").reduced()
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, PROMPT + GEN)))
    model = LM(cfg, init_params(cfg, seed=0, device="cpu").tree())
    out = []
    for c in (cfg, int8(cfg)):
        with torch.inference_mode():
            lg, cache = prefill(model.tree(), toks[:, :PROMPT], c,
                                s_max=PROMPT + GEN)
            logs = [lg]
            for i in range(GEN):
                lg, cache = decode_step(model.tree(), cache,
                                        toks[:, PROMPT + i:PROMPT + i + 1],
                                        PROMPT + i, c)
                logs.append(lg)
        out.append((logs, kv_cache_to_numpy(cache)))
    (la, ca), (lb, cb) = out
    assert all(torch.equal(a, b) for a, b in zip(la, lb, strict=True))
    assert set(ca) == set(cb) and all(np.array_equal(ca[k], cb[k])
                                      for k in ca)
    assert not any(k.endswith("_scale") for k in ca)


def test_int8_cache_tree_crosses_both_ways():
    """The port's int8 cache through `kv_cache_to_numpy` and back keeps its
    kinds, dtypes and bits; JAX's int8 prefill cache crosses into the port
    and back to the same numbers, scales included."""
    r = runs("zamba2-7b")["int8"]
    cfg = int8(get_config("zamba2-7b").reduced())
    back = kv_cache_from_numpy(cfg, r["pcache"], "cpu")
    again = kv_cache_to_numpy(back)
    assert set(again) == set(r["pcache"])
    for k, v in again.items():
        np.testing.assert_array_equal(v, r["pcache"][k])
    kinds = {type(c).__name__: c for g in back.values() for c in g.values()}
    assert kinds["KVCache"].k.dtype == torch.int8
    assert kinds["KVCache"].v_scale.dtype == torch.float32
    assert kinds["SSMState"].ssm.dtype == torch.float32
    jback = kv_cache_to_numpy(kv_cache_from_numpy(cfg, r["jcache"], "cpu"))
    assert set(jback) == set(r["jcache"])
    for k, w in r["jcache"].items():
        np.testing.assert_array_equal(jback[k], w.astype(np.float32))
    zero = [c for g in init_cache(cfg, B, 8, device="cpu").values()
            for c in g.values() if type(c).__name__ == "KVCache"][0]
    assert zero.k.shape[1:] == (B, 8, cfg.num_kv_heads, cfg.head_dim)
    assert zero.k_scale.shape == zero.k.shape[:-1]
    assert zero.k.dtype == torch.int8 and zero.k_scale.dtype == torch.float32
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_chip_smoke_card_cpu_gate_counts_int8_steps(monkeypatch):
    """chip_smoke.py's card-vs-CPU gate with the int8 cache (phase 39),
    driven on the CPU on both sides: every int8 leaf is recognised by its
    scale and held to one step, the float leaves to the tolerance; an
    int8 value moved by one step on one side is counted and passes, by
    two steps fails the gate."""
    from test_torch_hybrid_archs import chip_smoke
    cs = chip_smoke()
    cpu = torch.device("cpu")
    r = cs.card_cpu_phase("granite-8b", 0, cpu, 39, "int8")
    assert r["int8_apart"] == 0 and r["int8_values"] > 0
    assert r["decode"] == 0.0
    import repro_torch.interop as interop   # the gate imports it when run
    to_numpy = interop.kv_cache_to_numpy

    def shifted(by):
        calls = []

        def to(cache):
            flat = to_numpy(cache)
            calls.append(1)
            if len(calls) == 2:     # the "card" run
                k = next(k for k in flat if f"{k}_scale" in flat)
                flat[k].flat[0] = flat[k].flat[0] + by if flat[k].flat[0] \
                    <= 0 else flat[k].flat[0] - by
            return flat
        return to

    monkeypatch.setattr(interop, "kv_cache_to_numpy", shifted(1))
    assert cs.card_cpu_phase("granite-8b", 0, cpu, 39, "int8")[
        "int8_apart"] == 1
    monkeypatch.setattr(interop, "kv_cache_to_numpy", shifted(2))
    with pytest.raises(SystemExit):
        cs.card_cpu_phase("granite-8b", 0, cpu, 39, "int8")
