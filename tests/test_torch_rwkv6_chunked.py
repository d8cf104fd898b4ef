"""The chunked WKV route's host logic and its plain version, on the CPU.

`ref.wkv_subchunk_ref` computes the WKV in the factorisation of the
chunked route (csrc/rwkv6_chunked.cu): sub-chunks of 16 tokens, every
decay a running product of w's, the products' operands rounded as the
kernel rounds them (TF32).  Held here, on numpy-seeded inputs:

- in float32 against the exact recurrence `ref.wkv_ref`, from a zero and a
  non-zero state, at the lengths around the sub-chunk and the kernel's
  64-token chunk; and against the reference's Pallas kernel (interpret
  mode) and the reference model's `_wkv_chunked`.  Tolerance 1e-5 of the
  scale (max |out|, max |state|): products of the same w's associated
  otherwise and float32 sums in another order (seen: under 1e-6);
- at w near 1e-6, where it stays finite and matches `wkv_ref` while the
  log-space `wkv_chunked_ref` overflows;
- with TF32 and bfloat16 operands against float32: TF32 within 2e-3 of
  the output's scale and 1e-3 of the state's (a 2^-11 rounding of each
  operand; seen: 3.4e-4 and 3.2e-4), bfloat16 within 2e-2 and 1e-2 (2^-8;
  seen: 3.2e-3 and 2.8e-3);
- `route`, `accepts` and the launch `plan` of `kernels/rwkv6_scan.py`.

The CUDA kernel is held against these plain versions on the card by
chip_smoke.py (phase 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as k_rwkv  # noqa: E402

RTOL = 1e-5
OPERAND_TOL = {"tf32": (2e-3, 1e-3), "bfloat16": (2e-2, 1e-2)}
MAX_SMEM = 232448          # dynamic shared memory a block may take on Hopper
LENGTHS = (1, 15, 16, 17, 63, 64, 65, 200)


def _inputs(seed, b, ell, h, d, log_w0=None, state_scale=0.2):
    """r, k, v (0.3 N), w, u (0.3 N) and a state as float32 numpy: w a
    sigmoid of N (the reference's kernel test), or exp(-exp(log_w0 +
    0.5 N)) (the served init at log_w0 -6; w near 1e-6 at 2.63)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, ell, h, d)).astype(np.float32) * 0.3
               for _ in range(3))
    n = rng.standard_normal((b, ell, h, d))
    w = (1 / (1 + np.exp(-n)) if log_w0 is None
         else np.exp(-np.exp(log_w0 + 0.5 * n))).astype(np.float32)
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.3
    s = rng.standard_normal((b, h, d, d)).astype(np.float32) * state_scale
    return r, k, v, w, u, s


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _rel(got, want) -> float:
    got, want = (np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                            np.float32) for x in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("ell", LENGTHS)
def test_subchunk_form_matches_the_recurrence(ell, d):
    """Float32 operands, from a zero and from a non-zero state: output and
    final state against the token-by-token definition."""
    r, k, v, w, u, s = _t(*_inputs(ell + d, 2, ell, 3, d))
    for state in (None, s):
        want, want_state = ref.wkv_ref(r, k, v, w, u, state)
        out, new_state = ref.wkv_subchunk_ref(r, k, v, w, u, state,
                                              operands="float32")
        assert out.shape == (2, ell, 3, d) and out.dtype == torch.float32
        assert _rel(out, want) <= RTOL
        assert _rel(new_state, want_state) <= RTOL


@pytest.mark.parametrize("ell", [1, 17, 64, 200])
def test_subchunk_form_matches_the_reference_kernel(ell):
    """One sequence from a zero state against the reference's Pallas
    kernel in interpret mode, and a batch from a state against the
    reference model's chunked WKV."""
    r, k, v, w, u, s = _inputs(ell, 2, ell, 2, 64)
    pallas = jops.rwkv6_scan(*(jnp.asarray(a[0]) for a in (r, k, v, w)),
                             jnp.asarray(u), interpret=True)
    out, _ = ref.wkv_subchunk_ref(*_t(r[:1], k[:1], v[:1], w[:1], u), None,
                                  operands="float32")
    assert _rel(out[0], np.asarray(pallas)) <= RTOL
    want, want_state = jrwkv._wkv_chunked(
        *(jnp.asarray(a) for a in (r, k, v, w, u)), 16, jnp.asarray(s))
    out, state = ref.wkv_subchunk_ref(*_t(r, k, v, w, u, s),
                                      operands="float32")
    assert _rel(out, np.asarray(want)) <= RTOL
    assert _rel(state, np.asarray(want_state)) <= RTOL


def test_subchunk_form_stays_finite_where_the_log_form_overflows():
    """w near 1e-6: every running product underflows to the true decay;
    the log-space chunked form divides by underflowed cumulative decays."""
    r, k, v, w, u, s = _t(*_inputs(5, 1, 200, 3, 64, log_w0=2.63))
    assert float(w.median()) < 1e-5
    want, want_state = ref.wkv_ref(r, k, v, w, u, s)
    for operands in ("float32", "tf32"):
        out, state = ref.wkv_subchunk_ref(r, k, v, w, u, s,
                                          operands=operands)
        assert bool(torch.isfinite(out).all())
        tols = (RTOL, RTOL) if operands == "float32" else \
            OPERAND_TOL["tf32"]
        assert _rel(out, want) <= tols[0]
        assert _rel(state, want_state) <= tols[1]
    log_out, _ = ref.wkv_chunked_ref(r, k, v, w, u, 128, s)
    assert not bool(torch.isfinite(log_out).all())


@pytest.mark.parametrize("operands", ["tf32", "bfloat16"])
def test_rounded_operands_against_float32(operands):
    """The kernel's TF32 operands (and bfloat16 ones) against float32
    operands, over 400 tokens of the served decays from a state."""
    r, k, v, w, u, s = _t(*_inputs(3, 1, 400, 2, 64, log_w0=-6.0,
                                   state_scale=1.0))
    want, want_state = ref.wkv_subchunk_ref(r, k, v, w, u, s,
                                            operands="float32")
    out, state = ref.wkv_subchunk_ref(r, k, v, w, u, s, operands=operands)
    out_tol, state_tol = OPERAND_TOL[operands]
    assert 0 < _rel(out, want) <= out_tol
    assert 0 < _rel(state, want_state) <= state_tol


def test_round_operand_rounds_as_the_card():
    """TF32: 10 mantissa bits, to nearest, ties away from zero
    (cvt.rna); bfloat16 to nearest even; an unknown mode raises."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11])
    np.testing.assert_array_equal(
        ref.round_operand(x, "tf32").numpy(),
        np.array([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                  1.0 + 2.0 ** -9], np.float32))
    np.testing.assert_array_equal(ref.round_operand(x, "float32").numpy(),
                                  x.numpy())
    assert ref.round_operand(x, "bfloat16")[0] == 1.0
    with pytest.raises(ValueError, match="operands"):
        ref.round_operand(x, "fp8")


def test_route_takes_the_served_prefill_to_chunked():
    bf16, f32 = torch.bfloat16, torch.float32
    assert k_rwkv.route(bf16, 2, 5000, 40, 64) == "chunked"
    assert k_rwkv.route(bf16, 2, k_rwkv.CHUNKED_MIN_LEN, 40, 64) == "chunked"
    assert k_rwkv.route(bf16, 2, 1, 40, 64) == "recurrent"        # decode
    assert k_rwkv.route(bf16, 2, k_rwkv.CHUNKED_MIN_LEN - 1, 40,
                        64) == "recurrent"
    assert k_rwkv.route(f32, 2, 5000, 40, 64) == "recurrent"
    assert k_rwkv.route(bf16, 2, 5000, 40, 32) == "recurrent"     # not built
    assert k_rwkv.CHUNKED_HEAD_SIZES == (64,)


def test_accepts_is_what_a_forced_route_may_take():
    bf16, f32 = torch.bfloat16, torch.float32
    for ell in LENGTHS:                    # a forced chunked route takes any L
        assert k_rwkv.route(bf16, 1, ell, 1, 64) in k_rwkv.ROUTES
    assert k_rwkv.accepts("chunked", bf16, 64)
    assert not k_rwkv.accepts("chunked", f32, 64)
    assert not k_rwkv.accepts("chunked", bf16, 32)
    assert k_rwkv.accepts("recurrent", f32, 32)
    assert k_rwkv.accepts("recurrent", bf16, 64)
    with pytest.raises(ValueError, match="unknown route"):
        k_rwkv.accepts("wgmma", bf16, 64)


@pytest.mark.parametrize("b,ell,h", [(2, 5000, 40), (1, 1, 1), (3, 65, 7)])
def test_plan_covers_each_state_entry_once(b, ell, h):
    """Each (b, h, value column, key channel) of the state is held by one
    warp of one block, within a block's shared memory."""
    d = 64
    pl = k_rwkv.plan(b, ell, h, d)
    assert pl.grid == b * h and pl.threads == 256 and pl.smem <= MAX_SMEM
    assert (pl.chunk, pl.sub, pl.product_warps, pl.value_tile) == (
        64, 16, 4, 16)
    assert pl.smem == 221184          # csrc/rwkv6_chunked.cu's SMEM
    count = np.zeros((pl.grid, d, d), np.int32)
    for blk, c0, c1, i0, i1 in k_rwkv.warp_tiles(pl, d):
        count[blk, c0:c1, i0:i1] += 1
    assert np.all(count == 1)
    with pytest.raises(ValueError, match="no chunked plan"):
        k_rwkv.plan(b, ell, h, 32)
