"""The gradient of the port's attention against `jax.grad` of the
reference's jnp `mha`, on the CPU.

The flash backward kernels (csrc/flash_attention_bwd.cu and, for bf16 at
hd 64/128/256, csrc/flash_attention_bwd_sm90.cu) run only on the card;
here their plain version `ref.mha_bwd_ref` (the same formulas: the
softmax recomputed, D = rowsum(dO * O), the softcap's derivative
1 - tanh^2) and the autograd path of `ops.mha` (which sends a CPU tensor's
backward to it) are held to the reference's gradients, in float32, to
2e-5 of each gradient's scale (float32 sums in another order; seen at
most 2e-6), at causal, sliding-window, softcap, GQA, query-offset and
key-count settings.

A query row that keeps no key is where the two differ on purpose: the
reference's online softmax over -1e30 logits averages every key there,
while the port's flash kernels give 0 (phase 3 of chip_smoke.py holds
them to it), so the port's backward, the kernel and its plain version
alike, takes such a row's output as 0: its dq is 0 and it adds nothing
to dk and dv.  A causal training row always keeps its own key.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import mha as jax_mha  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as k_bwd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL = 2e-5

# (B, Sq, Skv, H, Hkv, hd, causal, window, softcap, q_offset, kv_len)
CASES = [
    (2, 37, 37, 4, 2, 16, True, None, None, 0, None),
    (1, 70, 70, 4, 1, 8, True, 16, None, 0, None),
    (2, 33, 33, 4, 4, 16, True, None, 30.0, 0, None),
    (1, 64, 64, 8, 4, 32, True, 24, 5.0, 0, None),
    (2, 20, 20, 2, 2, 8, False, None, 5.0, 0, 15),
    (1, 12, 40, 4, 2, 8, True, 8, 3.0, 20, 35),
]


def _inputs(seed, b, sq, skv, h, hkv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, hd)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, window, cap, qo, kvl):
    def f(q_, k_, v_):
        out = jax_mha(q_, k_, v_, causal=causal, window=window, softcap=cap,
                      q_offset=qo, kv_valid_len=kvl, kv_chunk=16)
        return jnp.sum(out * do)
    return [np.asarray(g) for g in jax.jit(jax.grad(f, (0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))]


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad(case):
    b, sq, skv, h, hkv, hd, causal, window, cap, qo, kvl = case
    q, k, v, do = _inputs(sum(case[:6]), b, sq, skv, h, hkv, hd)
    want = _jax_grads(q, k, v, do, causal, window, cap, qo, kvl)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = ref.mha_ref(tq, tk, tv, causal=causal, window=window, softcap=cap,
                    q_offset=qo, kv_valid_len=kvl, kv_chunk=16)
    got = ref.mha_bwd_ref(tq, tk, tv, o, tdo, causal=causal, window=window,
                          softcap=cap, q_offset=qo, kv_valid_len=kvl,
                          row_chunk=16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= RTOL


@pytest.mark.parametrize("case", CASES[:4])
def test_mha_autograd_path_matches_jax_grad(case):
    """`ops.mha` under grad: the forward's route, the backward through the
    plain version for CPU tensors, no kernel launched."""
    b, sq, skv, h, hkv, hd, causal, window, cap, qo, kvl = case
    q, k, v, do = _inputs(sum(case[:6]) + 1, b, sq, skv, h, hkv, hd)
    want = _jax_grads(q, k, v, do, causal, window, cap, qo, kvl)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ops.reset_launch_counts()
    out = ops.mha(tq, tk, tv, causal=causal, window=window, softcap=cap,
                  q_offset=qo, kv_valid_len=kvl, kv_chunk=16)
    out.backward(torch.from_numpy(do))
    for t, w in zip((tq, tk, tv), want):
        assert _rel(t.grad, w) <= RTOL
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_mha_without_grad_is_the_plain_forward():
    """Under inference_mode or no_grad `ops.mha` is the plain function, as
    serving has always called it."""
    q, k, v, _ = _inputs(3, 1, 20, 20, 4, 2, 8)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    want = ref.mha_ref(tq.detach(), tk.detach(), tv.detach(), causal=True)
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            out = ops.mha(tq, tk, tv, causal=True)
        assert out.grad_fn is None and torch.equal(out, want)


def test_plain_backward_rounds_once_to_the_input_dtype():
    q, k, v, do = _inputs(4, 1, 24, 24, 4, 2, 16)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o = ref.mha_ref(tq, tk, tv, causal=True)
    got = ref.mha_bwd_ref(tq, tk, tv, o, tdo, causal=True)
    want = ref.mha_bwd_ref(tq.float(), tk.float(), tv.float(), o.float(),
                           tdo.float(), causal=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.bfloat16())


def test_rows_with_no_kept_key_add_nothing():
    """Rows 27-47 keep no key (kv_len 20, window 8): their dq is 0, and dk
    and dv are those of the same call with their do zeroed."""
    q, k, v, do = _inputs(5, 1, 48, 48, 4, 2, 16)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    kw = dict(causal=True, window=8, softcap=50.0, kv_valid_len=20)
    o = ops.mha(tq, tk, tv, **kw)
    dq, dk, dv = ref.mha_bwd_ref(tq, tk, tv, o, tdo, **kw)
    empty = torch.arange(48) >= 27
    assert not dq[:, empty].any()
    cut = tdo.clone()
    cut[:, empty] = 0.0
    _, dk2, dv2 = ref.mha_bwd_ref(tq, tk, tv, o, cut, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    # the rows that keep a key match jax.grad of the reference's mha with
    # the empty rows' do zeroed (where the reference averages every key)
    want = _jax_grads(q, k, v, cut.numpy(), True, 8, 50.0, 0, 20)
    assert _rel(dq[:, ~empty], want[0][:, ~empty]) <= RTOL
    assert _rel(dk, want[1]) <= RTOL and _rel(dv, want[2]) <= RTOL


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        k_bwd.flash_attention_bwd(q, q, q, q, q, causal=True)
    assert k_bwd.launches == 0


# The sm90 route rounds P and dS to bf16 where they feed a product; with
# float32 inputs that moves each gradient by at most a bf16 rounding (2^-9
# relative) of each term, summed: within 4e-3 of its scale (seen at most
# 2.6e-3 on these cases).
P_BF16_RTOL = 4e-3


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_p_dtype_rounds_only_p_and_ds(case):
    """`p_dtype=None` is `mha_bwd_ref` itself, and so is float32 (a
    rounding that changes nothing: the rounded P and dS are the only
    change); bfloat16 rounds them and stays within P_BF16_RTOL of
    `jax.grad` of the reference's `mha`."""
    b, sq, skv, h, hkv, hd, causal, window, cap, qo, kvl = case
    q, k, v, do = _inputs(sum(case[:6]) + 2, b, sq, skv, h, hkv, hd)
    want = _jax_grads(q, k, v, do, causal, window, cap, qo, kvl)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo,
              kv_valid_len=kvl)
    o = ref.mha_ref(tq, tk, tv, kv_chunk=16, **kw)
    plain = ref.mha_bwd_ref(tq, tk, tv, o, tdo, **kw)
    for same in (None, torch.float32):
        got = ref.mha_bwd_ref(tq, tk, tv, o, tdo, p_dtype=same, **kw)
        assert all(torch.equal(g, p) for g, p in zip(got, plain))
    rounded = ref.mha_bwd_ref(tq, tk, tv, o, tdo, p_dtype=torch.bfloat16,
                              **kw)
    for g, p, w in zip(rounded, plain, want):
        assert g.dtype == torch.float32 and not torch.equal(g, p)
        assert _rel(g, w) <= P_BF16_RTOL


def test_plain_backward_p_dtype_keeps_bf16_inputs_close():
    """bf16 inputs, as the sm90 route takes them: the rounded P and dS
    move each gradient by less than FLASH_BWD_TOL (2^-7) of chip_smoke.py
    from the unrounded plain version, so the kernel's gate tells the two
    roundings apart only through the kernel's own error."""
    q, k, v, do = _inputs(6, 2, 64, 64, 4, 2, 64)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    kw = dict(causal=True, window=40, softcap=50.0)
    o = ref.mha_ref(tq, tk, tv, **kw)
    plain = ref.mha_bwd_ref(tq, tk, tv, o, tdo, **kw)
    rounded = ref.mha_bwd_ref(tq, tk, tv, o, tdo, p_dtype=torch.bfloat16,
                              **kw)
    for g, p in zip(rounded, plain):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float(), p.float().numpy()) <= 2.0 ** -7
