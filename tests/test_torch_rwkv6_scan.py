"""The port's WKV recurrence against the reference's, on the CPU.

The port's plain versions -- `rwkv6_scan_ref` and `ops.rwkv6_scan` (which a
CPU tensor reaches), the batched sequential `wkv_ref` and the chunked
`wkv_chunked_ref` -- are held against the reference's `rwkv6_scan_ref`, its
Pallas kernel in interpret mode and the model's `_wkv_chunked`, on the same
numpy-seeded inputs.  Tolerances: float32 1e-5 of the output's scale (the
einsums sum in another order than XLA's; seen: under 2e-6), bfloat16 5e-2
absolute as in tests/test_kernels.py (one bf16 rounding of outputs near 4).
The CUDA kernel is held against these plain versions on the card by
chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RTOL = 1e-5
BF16_ATOL = 5e-2


def _arrays(seed, shape, h, d):
    """r, k, v, w (shape) and u (h, d) as float32 numpy, drawn as the
    reference's kernel test draws them (w a sigmoid in (0, 1))."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) * 0.3
               for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.3
    return r, k, v, w, u


def _both(arrays, dtype):
    """The same bits as JAX arrays and torch tensors of `dtype`."""
    jx = [jnp.asarray(a, dtype) for a in arrays]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("s,h,d", [(64, 2, 64), (200, 3, 64), (128, 1, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_matches_reference_and_pallas_interpret(s, h, d, dtype):
    (jr, jk, jv, jw, ju), (r, k, v, w, u) = _both(
        _arrays(s + d, (s, h, d), h, d), dtype)
    want = jref.rwkv6_scan_ref(jr, jk, jv, jw, ju)
    pallas = jops.rwkv6_scan(jr, jk, jv, jw, ju, interpret=True)
    for got in (ref.rwkv6_scan_ref(r, k, v, w, u),
                ops.rwkv6_scan(r, k, v, w, u)):
        assert got.dtype == r.dtype and got.shape == r.shape
        for oracle in (want, pallas):
            if dtype == "float32":
                assert _rel(got, oracle) <= RTOL
            else:
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(oracle, np.float32),
                    atol=BF16_ATOL)


@pytest.mark.parametrize("ell", [5, 16, 40])
def test_wkv_chunked_matches_reference_from_a_state(ell):
    """Lengths below, at and across the chunk of 16, from a non-zero state:
    the output and the final state."""
    b, h, d, chunk = 2, 3, 32, 16
    arrays = _arrays(ell, (b, ell, h, d), h, d)
    state = np.random.default_rng(ell + 1).standard_normal(
        (b, h, d, d)).astype(np.float32) * 0.2
    (jr, jk, jv, jw, ju, js), (r, k, v, w, u, st) = _both(
        arrays + (state,), "float32")
    want_out, want_state = jrwkv._wkv_chunked(jr, jk, jv, jw, ju, chunk, js)
    out, new_state = ref.wkv_chunked_ref(r, k, v, w, u, chunk, st)
    assert out.shape == (b, ell, h, d) and new_state.shape == (b, h, d, d)
    assert _rel(out, want_out) <= RTOL
    assert _rel(new_state, want_state) <= RTOL
    _, zero_state = jrwkv._wkv_chunked(jr, jk, jv, jw, ju, chunk, None)
    assert _rel(ref.wkv_chunked_ref(r, k, v, w, u, chunk)[1],
                zero_state) <= RTOL


@pytest.mark.parametrize("ell,chunk", [(1, 128), (7, 4), (33, 16), (64, 64)])
def test_sequential_wkv_matches_chunked(ell, chunk):
    """The kernel's exact definition (token by token) against the chunked
    form, from a state; L 1 is the decode step."""
    b, h, d = 2, 2, 64
    r, k, v, w, u = (torch.from_numpy(a) for a in
                     _arrays(ell + chunk, (b, ell, h, d), h, d))
    state = torch.randn(b, h, d, d, generator=torch.Generator().manual_seed(
        ell)) * 0.2
    out, new_state = ref.wkv_ref(r, k, v, w, u, state)
    want_out, want_state = ref.wkv_chunked_ref(r, k, v, w, u, chunk, state)
    assert _rel(out, want_out.numpy()) <= RTOL
    assert _rel(new_state, want_state.numpy()) <= RTOL


def test_sequential_wkv_step_is_the_reference_decode_recurrence():
    """One step of `wkv_ref` is the reference decode's einsum, bit for bit
    in its state update (w S + k v^T, rounded as written)."""
    b, h, d = 2, 3, 32
    r, k, v, w, u = _arrays(3, (b, 1, h, d), h, d)
    s = np.random.default_rng(4).standard_normal((b, h, d, d)).astype(
        np.float32)
    kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]
    want_state = w[:, 0, :, :, None] * s + kv
    want_out = np.einsum("bhd,bhde->bhe", r[:, 0], s + u[None, :, :, None]
                         * kv)
    out, new_state = ref.wkv_ref(*(torch.from_numpy(a) for a in
                                   (r, k, v, w, u, s)))
    np.testing.assert_array_equal(new_state.numpy(), want_state)
    assert _rel(out[:, 0], want_out) <= RTOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_wkv_writes_the_state_in_place_on_the_cpu(dtype):
    """ops.wkv on CPU tensors: the chunked form, its output in r's dtype, its
    final state written into `state`; no kernel launch."""
    b, ell, h, d = 2, 21, 2, 32
    r, k, v, w, u = (torch.from_numpy(a) for a in
                     _arrays(9, (b, ell, h, d), h, d))
    r, k, v = (t.to(getattr(torch, dtype)) for t in (r, k, v))
    state = torch.randn(b, h, d, d, generator=torch.Generator().manual_seed(
        2)) * 0.2
    want_out, want_state = ref.wkv_chunked_ref(r, k, v, w, u, 8, state)
    ops.reset_launch_counts()
    buf = state.clone()
    out = ops.wkv(r, k, v, w, u, buf, chunk=8)
    assert out.dtype == r.dtype and out.shape == (b, ell, h, d)
    np.testing.assert_array_equal(out.float().numpy(),
                                  want_out.to(r.dtype).float().numpy())
    np.testing.assert_array_equal(buf.numpy(), want_state.numpy())
    assert ops.launch_counts()["rwkv6_scan"] == 0
