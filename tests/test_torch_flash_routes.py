"""The flash-attention routes' host logic and the split route's plain
version, on the CPU.

`flash_attention.route` picks `sm90` (tensor cores, bf16 prefill), `split`
(split-KV decode) or `simt`; `split_plan` cuts the valid keys into splits
for the split route; `ref.mha_split_ref` computes attention as the split
kernel does (per-split (m, l, acc), merged in the combine kernel's
order) and is held here
against the reference model's `mha` and the port's `ref.mha_ref` on the
same numpy-seeded inputs.  Tolerances: float32 1e-5 absolute (sums in
another order than XLA's and than one chunked scan), bfloat16 2e-2 (one
bf16 rounding of the output, as in tests/test_kernels.py).  The CUDA
kernels are held against these plain versions on the card by
chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as k_flash  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as k_bwd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed, b, sq, skv, h, hkv, hd, dtype):
    """(jax q, k, v) and (torch q, k, v) with the same bits."""
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal(s) * 0.5).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd))]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


# ------------------------------------------------------------- route ---

@pytest.mark.parametrize("dtype,b,sq,skv,h,hkv,hd,kv_len,want", [
    (torch.bfloat16, 2, 5000, 5000, 8, 4, 256, 5000, "sm90"),   # prefill
    (torch.float32, 2, 5000, 5000, 8, 4, 256, 5000, "simt"),
    (torch.float32, 1, 5000, 5000, 8, 4, 256, 5000, "simt"),    # phase 11
    (torch.bfloat16, 2, 1, 4096, 8, 4, 256, 4096, "split"),     # ring
    (torch.bfloat16, 2, 1, 5032, 8, 4, 256, 5011, "split"),     # global
    (torch.float32, 2, 1, 5032, 8, 4, 256, 5011, "split"),
    (torch.bfloat16, 1, 130, 130, 2, 2, 72, 130, "simt"),       # hd 72
    (torch.bfloat16, 2, 300, 300, 8, 4, 128, 300, "sm90"),
    (torch.bfloat16, 1, 37, 37, 4, 1, 64, 37, "sm90"),
    (torch.bfloat16, 1, 8, 100, 8, 1, 256, 100, "split"),       # 64 rows
    (torch.bfloat16, 1, 9, 100, 8, 1, 256, 100, "sm90"),        # 72 rows
    (torch.bfloat16, 2, 3, 1000, 8, 4, 36, 1000, "simt"),       # hd % 8
])
def test_route_picks_by_dtype_rows_and_head_dim(dtype, b, sq, skv, h, hkv,
                                                hd, kv_len, want):
    assert k_flash.route(dtype, b, sq, skv, h, hkv, hd, kv_len) == want
    assert k_flash.accepts(want, dtype, sq, h, hkv, hd)


def test_routes_refuse_what_they_do_not_take():
    assert not k_flash.accepts("sm90", torch.float32, 5000, 8, 4, 256)
    assert not k_flash.accepts("sm90", torch.bfloat16, 500, 8, 4, 72)
    assert not k_flash.accepts("split", torch.bfloat16, 33, 8, 4, 256)
    assert not k_flash.accepts("split", torch.bfloat16, 1, 8, 4, 36)
    assert k_flash.accepts("simt", torch.float32, 5000, 8, 4, 72)
    with pytest.raises(ValueError, match="unknown route"):
        k_flash.accepts("fast", torch.bfloat16, 1, 8, 4, 256)


# -------------------------------------------------------- split_plan ---

def _ranges(kv_len, splits, chunk):
    return [(s * chunk, min((s + 1) * chunk, kv_len)) for s in range(splits)]


@pytest.mark.parametrize("sm_count", [1, 16, 78, 132])
@pytest.mark.parametrize("groups", [1, 8, 64, 300])
def test_split_plan_covers_keys_once_and_fills_the_card(sm_count, groups):
    for kv_len in list(range(0, 300)) + [1000, 4096, 5011, 32768, 131072]:
        splits, chunk = k_flash.split_plan(kv_len, groups, sm_count)
        assert splits >= 1 and chunk % 16 == 0
        assert chunk >= k_flash.SPLIT_MIN_CHUNK
        ranges = _ranges(kv_len, splits, chunk)
        # [0, kv_len) once each, in order: the ranges abut
        assert ranges[0][0] == 0 and ranges[-1][1] == kv_len
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        if kv_len > 0:                                  # none empty
            assert all(hi > lo for lo, hi in ranges)
        # the card holds at least an SM's worth of blocks unless kv_len is
        # too short for that many chunks of SPLIT_MIN_CHUNK keys
        if kv_len >= k_flash.SPLIT_MIN_CHUNK * -(-sm_count // groups):
            assert splits * groups >= sm_count


def test_split_plan_of_the_served_decode():
    """gemma2-2b decode at B 2, Hkv 4, 2 rows a kv head, on 132 SMs:
    32 splits of 128 keys on the ring, 32 of 160 on the global cache."""
    assert k_flash.split_plan(4096, 8, 132) == (32, 128)
    assert k_flash.split_plan(5011, 8, 132) == (32, 160)
    assert k_flash.split_plan(1, 8, 132) == (1, 64)


@pytest.mark.parametrize("b,sq,h,hkv,want", [
    (2, 1, 8, 4, 8),        # the served decode: 2 rows a kv head
    (1, 8, 8, 1, 8),        # 64 rows of one kv head: 8 groups of 8
    (2, 3, 8, 4, 8),        # 6 rows: one group
    (1, 9, 8, 8, 16),       # 9 rows: two groups
])
def test_split_groups_counts_row_groups(b, sq, h, hkv, want):
    assert k_flash.split_groups(b, sq, h, hkv) == want


def test_split_groups_give_the_served_plan():
    assert k_flash.split_plan(4096, k_flash.split_groups(2, 1, 8, 4),
                              132) == (32, 128)


# ----------------------------------------------------- mha_split_ref ---

SPLIT_CASES = [
    # (b, sq, skv, h, hkv, hd, causal, window, softcap, q_offset, kv_len,
    #  num_splits, chunk): what the case covers
    (2, 1, 256, 4, 4, 32, False, None, 50.0, 99, 100, 8, None),  # > kv_len
    (1, 1, 256, 8, 4, 32, False, 50, None, 200, 256, 4, None),   # window
    (2, 1, 300, 8, 1, 16, False, None, None, 290, 291, 5, 64),   # GQA 8
    (1, 3, 200, 8, 4, 16, True, None, 30.0, 150, 180, 4, None),  # Sq 3
    (2, 3, 128, 4, 2, 32, True, 40, 50.0, 100, 103, 6, 32),      # Sq 3, win
    (1, 1, 64, 2, 2, 16, False, None, 50.0, 0, 1, 3, None),      # kv_len 1
]


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_split_ref_matches_reference_mha_and_mha_ref(case, dtype):
    (b, sq, skv, h, hkv, hd, causal, window, cap, qo, kvl, ns,
     chunk) = case
    (jq, jk, jv), (q, k, v) = _inputs(sum(case[:6]), b, sq, skv, h, hkv,
                                      hd, dtype)
    got = ref.mha_split_ref(q, k, v, causal=causal, window=window,
                            softcap=cap, q_offset=qo, kv_valid_len=kvl,
                            num_splits=ns, chunk=chunk)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = jattn.mha(jq, jk, jv, causal=causal, window=window, softcap=cap,
                     q_offset=qo, kv_valid_len=kvl)
    plain = ref.mha_ref(q, k, v, causal=causal, window=window, softcap=cap,
                        q_offset=qo, kv_valid_len=kvl)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=TOL[dtype])


@pytest.mark.parametrize("rows_per_kv_head", [1, 2, 8])
def test_mha_split_ref_with_the_kernels_plan(rows_per_kv_head):
    """The split route's own plan at a decode of 4096 valid keys (splits of
    128 keys on 132 SMs), GQA groups 1, 2 and 8, float32."""
    hkv, hd, kvl = 2, 16, 4096
    h = hkv * rows_per_kv_head
    (jq, jk, jv), (q, k, v) = _inputs(rows_per_kv_head, 2, 1, kvl, h, hkv,
                                      hd, "float32")
    ns, chunk = k_flash.split_plan(kvl, 2 * hkv, 132)
    assert ns > 8
    got = ref.mha_split_ref(q, k, v, causal=False, softcap=50.0,
                            q_offset=kvl - 1, kv_valid_len=kvl,
                            num_splits=ns, chunk=chunk)
    want = jattn.mha(jq, jk, jv, causal=False, softcap=50.0,
                     q_offset=kvl - 1, kv_valid_len=kvl, kv_chunk=4096)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_rows_with_no_kept_key_give_zero_in_mha_split_ref():
    """Rows 23-31 keep no key (behind the window of 64 and past kv_len
    100): they give 0, as the split and sm90 kernels give; the kept rows
    agree with the reference model's `mha`, float32 1e-5."""
    (jq, jk, jv), (q, k, v) = _inputs(5, 2, 32, 256, 8, 4, 16, "float32")
    kw = dict(causal=True, window=64, softcap=50.0, q_offset=140)
    got = ref.mha_split_ref(q, k, v, kv_valid_len=100, num_splits=4, **kw)
    want = jattn.mha(jq, jk, jv, kv_valid_len=100, **kw)
    assert not got[:, 23:].any()
    np.testing.assert_allclose(got[:, :23].numpy(),
                               np.asarray(want)[:, :23], atol=1e-5)


@pytest.mark.parametrize("case", SPLIT_CASES[:4])
def test_mha_ref_p_dtype_rounds_only_the_pv_product(case):
    """`p_dtype=None` is `mha_ref` itself; bfloat16 rounds each chunk's p
    before P V (the tensor-core route's rounding): float32 inputs then
    differ from the unrounded result, by at most the bf16 rounding of p
    (2^-8 relative, 4e-3 of max |o| here), and bf16 inputs in 64-key chunks
    stay within TOL of the reference model's `mha`."""
    b, sq, skv, h, hkv, hd, causal, window, cap, qo, kvl = case[:11]
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo,
              kv_valid_len=kvl)
    _, (q, k, v) = _inputs(7, b, sq, skv, h, hkv, hd, "float32")
    plain = ref.mha_ref(q, k, v, **kw)
    assert torch.equal(ref.mha_ref(q, k, v, p_dtype=None, **kw), plain)
    rounded = ref.mha_ref(q, k, v, p_dtype=torch.bfloat16, **kw)
    assert not torch.equal(rounded, plain)
    np.testing.assert_allclose(rounded.numpy(), plain.numpy(),
                               atol=4e-3 * float(plain.abs().max()))
    (jq, jk, jv), (q, k, v) = _inputs(7, b, sq, skv, h, hkv, hd, "bfloat16")
    got = ref.mha_ref(q, k, v, kv_chunk=64, p_dtype=torch.bfloat16, **kw)
    want = jattn.mha(jq, jk, jv, causal=causal, window=window, softcap=cap,
                     q_offset=qo, kv_valid_len=kvl)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL["bfloat16"])


def test_mha_split_ref_rejects_splits_that_miss_keys():
    q = torch.zeros(1, 1, 2, 8)
    k = torch.zeros(1, 100, 2, 8)
    with pytest.raises(ValueError, match="do not cover"):
        ref.mha_split_ref(q, k, k, causal=False, kv_valid_len=100,
                          num_splits=3, chunk=32)


# ------------------------------------------------------ launch counts ---

def test_reset_launch_counts_zeroes_each_route():
    k_flash.launches_sm90, k_flash.launches_split = 3, 4
    k_flash.launches_simt = 5
    ops.reset_launch_counts()
    assert k_flash.route_counts() == {"sm90": 0, "split": 0, "simt": 0}
    assert ops.launch_counts()["flash_attention"] == 0


# ---------------------------------------------------- backward routes ---

@pytest.mark.parametrize("dtype,sq,h,hkv,hd,want", [
    (torch.bfloat16, 2048, 8, 4, 256, "sm90"),     # gemma2-2b training
    (torch.bfloat16, 257, 8, 4, 128, "sm90"),
    (torch.bfloat16, 37, 4, 1, 64, "sm90"),
    (torch.bfloat16, 1, 8, 4, 256, "sm90"),        # any Sq
    (torch.float32, 2048, 8, 4, 256, "simt"),
    (torch.float32, 37, 4, 1, 64, "simt"),
    (torch.bfloat16, 130, 2, 2, 72, "simt"),       # phase 3's hd 72
    (torch.bfloat16, 500, 20, 20, 80, "simt"),     # hubert-xlarge
    (torch.bfloat16, 500, 32, 32, 112, "simt"),    # zamba2-7b
])
def test_backward_route_picks_by_dtype_and_head_dim(dtype, sq, h, hkv, hd,
                                                    want):
    assert k_bwd.route(dtype, 2, sq, sq, h, hkv, hd, sq) == want
    assert k_bwd.accepts(want, dtype, sq, h, hkv, hd)
    assert k_bwd.accepts("simt", dtype, sq, h, hkv, hd)


def test_backward_routes_refuse_what_they_do_not_take():
    assert not k_bwd.accepts("sm90", torch.float32, 2048, 8, 4, 256)
    assert not k_bwd.accepts("sm90", torch.bfloat16, 130, 2, 2, 72)
    assert k_bwd.ROUTES == ("sm90", "simt")
    with pytest.raises(ValueError, match="unknown route"):
        k_bwd.accepts("split", torch.bfloat16, 1, 8, 4, 256)


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 72),
                                      (torch.float32, 64),
                                      (torch.float32, 256)])
def test_backward_wrapper_refuses_a_forced_route_that_does_not_take(dtype,
                                                                    hd):
    q = torch.zeros(1, 4, 2, hd, dtype=dtype)
    with pytest.raises(ValueError, match="route 'sm90' does not take"):
        k_bwd.flash_attention_bwd(q, q, q, q, q, causal=True, route="sm90")
    with pytest.raises(ValueError, match="unknown route"):
        k_bwd.flash_attention_bwd(q, q, q, q, q, causal=True, route="fast")
    assert k_bwd.route_counts() == {"sm90": 0, "simt": 0}


@pytest.mark.parametrize("route", [None, "sm90", "simt"])
def test_backward_wrapper_refuses_cpu_tensors_on_every_route(route):
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        k_bwd.flash_attention_bwd(q, q, q, q, q, causal=True, route=route)
    assert k_bwd.launches == 0
    assert k_bwd.route_counts() == {"sm90": 0, "simt": 0}


def test_reset_launch_counts_zeroes_each_backward_route():
    k_bwd.launches_sm90, k_bwd.launches_simt, k_bwd.launches = 3, 4, 7
    assert k_bwd.route_counts() == {"sm90": 3, "simt": 4}
    k_bwd.reset_route_counts()
    assert k_bwd.route_counts() == {"sm90": 0, "simt": 0}
    k_bwd.launches_sm90, k_bwd.launches_simt = 1, 2
    ops.reset_launch_counts()
    assert k_bwd.route_counts() == {"sm90": 0, "simt": 0}
    assert ops.launch_counts()["flash_attention_bwd"] == 0
