"""The port's twins of `examples/serve_batched.py` and
`examples/train_lm.py` (`repro_torch.launch.serve_batched`, `train_lm`),
run on the CPU against the reference.

serve_batched runs at the example's own size (reduced gemma2-2b, float32,
B 4, a 24-token prompt, 16 greedy tokens, 40 cache slots).  The
example's docstring promises a decode-vs-forward check its code never
makes; this test makes it: each decode step's logits equal a prefill of
the prompt and the tokens so far at 1e-5 of their scale.  Its prefill
logits equal the reference's `prefill` on the same weights, carried
across, at 1e-5.

train_lm runs `--small` (granite-20m) for 3 steps at B 2 x 32: its
losses equal the reference's jitted `make_train_step` from the same
state, carried across, at 1e-5 relative; its printed lines have the
example's keys; its checkpoint reads back with `repro.checkpoint.restore`;
each parameter leaf's update over the three steps (its restored value
less its initial one) is nonzero and equals the reference's within
UPDATE_RTOL of the update's norm (read: at most 1.2e-4), so a twin that
left out its last step (~0.15 of the update at this schedule's lr 3e-4,
2.3e-4, 9.7e-5) or never updated a leaf (1.0) fails; elementwise within 2
lr a step (read: at most 0.036 of the update's max), as an element whose
gradient is near zero takes AdamW's update of either sign on a rounding;
the head's singular values are finite.
"""
import contextlib
import dataclasses
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import synthetic_lm_batches as ref_batches  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models import serving as ref_serving  # noqa: E402
from repro_torch.interop import train_state_to_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve_batched, steps, train_lm  # noqa: E402
from repro_torch.models.serving import prefill  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
STEPS, BATCH, SEQ, LR = 3, 2, 32, 3e-4
UPDATE_RTOL = 1e-3


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", k)))


def flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(_key(k) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def carried(like, leaves: dict):
    """The reference's tree `like` with each leaf taken from `leaves` (by
    path) in the reference leaf's dtype."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(leaves[".".join(_key(k) for k in path)], leaf.dtype)
        for path, leaf in paths])


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().strip().splitlines()


def test_serve_batched_decode_equals_forward_and_the_reference():
    ops.reset_launch_counts()
    r, lines = run(lambda: serve_batched.main(["--device", "cpu"]))
    b, p, g = serve_batched.BATCH, serve_batched.PROMPT_LEN, \
        serve_batched.GEN
    assert re.fullmatch(rf"prefill: batch={b} len={p} in \d+\.\d\ds",
                        lines[0])
    assert re.fullmatch(rf"decoded {g} tokens x {b} requests in \d+\.\d\ds "
                        r"\(\d+\.\d tok/s on cpu\)", lines[1])
    toks = r["tokens"]
    assert toks.shape == (b, g) and len(r["logits"]) == g
    assert lines[2:] == [f"  req{i}: {toks[i].tolist()}" for i in range(b)]
    model, prompts = r["model"], r["prompts"]
    tree, cfg = model.tree(), model.cfg
    errs = []
    with torch.inference_mode():
        for i in range(1, g):
            seq = torch.cat([prompts, toks[:, :i]], dim=1)
            want, _ = prefill(tree, seq, cfg)
            errs.append(rel(r["logits"][i], want))
            assert torch.equal(toks[:, i], r["logits"][i][:, -1].argmax(-1))
    assert max(errs) <= 1e-5, errs

    rcfg = ref_config("gemma2-2b").reduced()
    params = carried(ref_init(jax.random.PRNGKey(0), rcfg),
                     {k: v.numpy() for k, v in
                      model.state_dict().items()})
    want, _ = jax.jit(lambda pp, t: ref_serving.prefill(
        pp, {"tokens": t}, rcfg, s_max=p + g, remat=False))(
        params, jnp.asarray(prompts.numpy(), jnp.int32))
    assert rel(r["logits"][0], want) <= 1e-5
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_train_lm_small_matches_the_reference(tmp_path):
    cfg = train_lm.build_config(small=True)
    rcfg = example("train_lm").build_config(small=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(train_lm.build_config(small=False)) == \
        dataclasses.asdict(example("train_lm").build_config(small=False))
    popt = steps.default_optimizer(cfg, lr=LR, total_steps=STEPS)
    start = train_state_to_numpy(steps.init_train_state(cfg, popt, seed=0,
                                                        device="cpu"))
    jopt = jsteps.default_optimizer(rcfg, lr=LR, total_steps=STEPS)
    js = carried(jsteps.init_train_state(jax.random.PRNGKey(0), rcfg, jopt),
                 start)
    jstep = jax.jit(jsteps.make_train_step(rcfg, jopt, remat=True))
    want = []
    for _, b in zip(range(STEPS), ref_batches(
            rcfg.vocab_size, SEQ, BATCH, rcfg.mtl.num_tasks, seed=1)):
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        want.append({k: float(m[k]) for k in ("loss", "lm_loss",
                                              "probe_loss", "mtl_v_norm")})

    ckpt = str(tmp_path / "ckpt")
    r, lines = run(lambda: train_lm.main([
        "--small", "--device", "cpu", "--steps", str(STEPS), "--batch",
        str(BATCH), "--seq", str(SEQ), "--ckpt", ckpt]))
    n = sum(v.size for k, v in start.items() if k.startswith("params."))
    assert r["n_params"] == n
    assert lines[0] == (f"model granite-20m: {n / 1e6:.1f}M params, 4L x "
                        "d256, vocab 8192")
    step_line = re.compile(r"step +(\d+)  loss +(\S+)  lm +(\S+)  "
                           r"probe +(\S+)  Vnorm +(\S+)  \( *\d+\.\ds\)")
    printed = [step_line.fullmatch(x) for x in lines[1:-1]]
    assert all(printed) and [int(m[1]) for m in printed] == [0, 1, 2]
    assert lines[-1].startswith(f"checkpoint saved to {ckpt}; MTL head "
                                "singular values (nuclear coupling): [")
    for row, w in zip(r["log"], want, strict=True):
        for k, jk in (("loss", "loss"), ("lm", "lm_loss"),
                      ("probe", "probe_loss"), ("Vnorm", "mtl_v_norm")):
            assert abs(row[k] - w[jk]) <= 1e-5 * abs(w[jk]), (row, w)
    sv = r["singular_values"]
    assert len(sv) == 6 and all(np.isfinite(sv))

    assert jckpt.latest_step(ckpt) == STEPS == r["step"]
    back = flat(jckpt.restore(ckpt, STEPS, js.params))
    ref_params = flat(js.params)
    assert set(back) == set(ref_params)
    for k, w in ref_params.items():
        w0 = start[f"params.{k}"]
        d_want, d_got = w - w0, back[k] - w0
        assert np.abs(d_want).max() > 0 and np.abs(d_got).max() > 0, k
        assert np.linalg.norm(d_got - d_want) <= UPDATE_RTOL * \
            np.linalg.norm(d_want), k
        assert np.abs(d_got - d_want).max() <= 2 * LR * STEPS, k
