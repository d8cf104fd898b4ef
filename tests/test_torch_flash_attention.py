"""The port's attention against the reference's, on the CPU.

The port's plain versions (`ops.flash_attention`, `ops.mha`, which a CPU
tensor reaches) are held against the reference's Pallas kernel in
interpret mode, its O(S^2) oracle and its model `mha`, on the same
numpy-seeded inputs.  Tolerances: float32 2e-5 absolute (einsum sums in
another order than XLA's), bfloat16 2e-2 (one bf16 rounding of the output,
as in tests/test_kernels.py).  At hd 72, 80, 112 and 192 the reference
pads hd to a lane multiple and scales by its `true_hd`; the port's sm90
route pads to the next 64 columns on the card, and its plain version, held
here, never pads.  The CUDA kernel is held against these plain versions on
the card by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import softmax_scale  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, q_shape, kv_shape, dtype):
    """(jax q, k, v) and (torch q, k, v) with the same bits."""
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal(s) * 0.3).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("s,h,hkv,hd", [(64, 4, 4, 64), (200, 4, 2, 72),
                                        (256, 8, 1, 128), (100, 2, 2, 32),
                                        (96, 4, 4, 80), (150, 4, 4, 112),
                                        (70, 4, 1, 192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_interpret_and_oracle(s, h, hkv, hd,
                                                             dtype):
    (jq, jk, jv), (q, k, v) = _inputs(s + hd, (s, h, hd), (s, hkv, hd),
                                      dtype)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = jops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    rep = h // hkv
    oracle = jref.sliding_flash_attention_ref(
        jq, jnp.repeat(jk, rep, axis=1), jnp.repeat(jv, rep, axis=1),
        window=None)
    _close(got, pallas, TOL[dtype])
    _close(got, oracle, TOL[dtype])


@pytest.mark.parametrize("s,h,hkv,window,softcap", [
    (100, 2, 2, 16, 30.0), (180, 4, 2, 64, None), (130, 4, 1, 200, 50.0),
    (64, 8, 4, 1, 50.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_window_softcap_gqa(s, h, hkv, window, softcap,
                                            dtype):
    (jq, jk, jv), (q, k, v) = _inputs(s, (s, h, 48), (s, hkv, 48), dtype)
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=softcap)
    pallas = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  softcap=softcap, interpret=True)
    _close(got, pallas, TOL[dtype])


def test_plain_oracle_matches_reference_oracle_non_causal():
    (jq, jk, jv), (q, k, v) = _inputs(5, (40, 2, 16), (40, 2, 16),
                                      "float32")
    got = ref.sliding_flash_attention_ref(q, k, v, window=8, causal=False,
                                          softcap=20.0)
    want = jref.sliding_flash_attention_ref(jq, jk, jv, window=8,
                                            causal=False, softcap=20.0)
    _close(got, want, TOL["float32"])


# (label, B, Sq, Skv, H, Hkv, hd, causal, window, softcap, q_offset,
#  kv_valid_len, kv_chunk): prefill over several chunks with a padded last
# chunk, decode on a ring and on a global cache, a chunked prefill with a
# query offset.
MHA_CASES = [
    ("prefill", 2, 100, 100, 4, 2, 32, True, None, 50.0, 0, None, 32),
    ("prefill-window", 1, 150, 150, 4, 4, 64, True, 40, 50.0, 0, None, 64),
    ("decode-ring", 2, 1, 64, 8, 4, 32, False, None, 50.0, 130, 64, 4096),
    ("decode-global", 2, 1, 96, 4, 2, 32, False, None, 50.0, 70, 71, 4096),
    ("decode-early", 1, 1, 64, 2, 1, 16, False, None, None, 9, 10, 4096),
    ("q_offset", 1, 16, 80, 4, 2, 32, True, 32, None, 48, 64, 32),
]


@pytest.mark.parametrize("case", MHA_CASES, ids=[c[0] for c in MHA_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_matches_reference_model_mha(case, dtype):
    (_, b, sq, skv, h, hkv, hd, causal, window, softcap, q_offset, valid,
     chunk) = case
    (jq, jk, jv), (q, k, v) = _inputs(sq * skv, (b, sq, h, hd),
                                      (b, skv, hkv, hd), dtype)
    got = ops.mha(q, k, v, causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset, kv_valid_len=valid, kv_chunk=chunk)
    want = jattn.mha(jq, jk, jv, causal=causal, window=window,
                     softcap=softcap, q_offset=q_offset,
                     kv_valid_len=None if valid is None else jnp.asarray(
                         valid, jnp.int32), kv_chunk=chunk)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, TOL[dtype])


def test_mha_chunking_changes_only_the_order_of_sums():
    """The plain version's kv_chunk is the order of its sums, not its
    function: every chunk size gives the one-chunk result."""
    _, (q, k, v) = _inputs(3, (2, 70, 4, 32), (2, 70, 2, 32), "float32")
    one = ops.mha(q, k, v, causal=True, window=20, softcap=50.0,
                  kv_chunk=4096)
    for chunk in (1, 7, 64):
        got = ops.mha(q, k, v, causal=True, window=20, softcap=50.0,
                      kv_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), one.numpy(), atol=2e-6)


def test_softmax_scale_rounds_as_the_reference():
    for hd in (32, 48, 64, 72, 128, 256):
        want = float(1.0 / jnp.sqrt(jnp.asarray(hd, jnp.float32)))
        assert softmax_scale(hd) == want
