"""The port's minibatch selection (`repro_torch.kernels.ref`) against the
reference's (`repro.kernels.ref`, the Pallas `sample_mask` in interpret
mode, and the kernel's `_scalars` block), on the same seeds.

All bitwise: the cutoffs, the scalar blocks and the keep bits are integer
functions of (n, batch_size, seed, n_t).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lstsq_grad_sampled import _scalars  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SEEDS = (0, 5, 0x9E3779B9, 0xFFFFFFFF)
# (n, batch_size): n = 1, a short buffer, the cohort capacity, a buffer
# past one 512-row TPU strip; b = 1, a minibatch, b >= n.
GRID = [(1, 1), (1, 4), (7, 1), (7, 3), (7, 7), (7, 9), (400, 1), (400, 32),
        (400, 400), (513, 32), (513, 600)]


def _n_ts(n):
    return sorted({0, 1, n // 3, n - 1, n})


def _u32(x):
    return jnp.asarray(x, jnp.uint32)


@pytest.mark.parametrize("n,b", GRID, ids=[f"{n}-{b}" for n, b in GRID])
def test_scalar_block_bitwise_vs_jax(n, b):
    for seed in SEEDS:
        want = np.asarray(_scalars(n, b, _u32(seed))).reshape(4)
        np.testing.assert_array_equal(ref.sample_scalars(n, b, [seed])[0],
                                      want)
        for n_t in _n_ts(n):
            want = np.asarray(_scalars(n, b, _u32(seed),
                                       jnp.int32(n_t))).reshape(4)
            got = ref.sample_scalars(n, b, [seed], [n_t])[0]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{(n, b, seed, n_t)}")


def test_scalar_blocks_of_many_events_match_one_by_one():
    """`sample_scalars` hashes events in chunks: a run of 2500 events gives
    each event the block it gets alone."""
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2**32, 2500, dtype=np.uint64).astype(np.uint32)
    n_ts = rng.integers(0, 60, 2500)
    many = ref.sample_scalars(60, 9, seeds, n_ts)
    for i in range(0, 2500, 97):
        np.testing.assert_array_equal(
            many[i], ref.sample_scalars(60, 9, [seeds[i]], [n_ts[i]])[0])


@pytest.mark.parametrize("n,b", GRID, ids=[f"{n}-{b}" for n, b in GRID])
def test_cutoffs_and_masks_bitwise_vs_jax(n, b):
    for seed in SEEDS:
        s = _u32(seed)
        assert ref.sample_cutoff(n, b, seed) == tuple(
            int(v) for v in jref.sample_cutoff(n, b, s))
        mask = ref.sample_mask_ref(n, b, seed).numpy()
        np.testing.assert_array_equal(mask,
                                      np.asarray(jref.sample_mask_ref(n, b, s)))
        assert mask.sum() == min(b, n)
        for n_t in _n_ts(n):
            nt = jnp.int32(n_t)
            assert ref.sample_cutoff_masked(n, b, seed, n_t) == tuple(
                int(v) for v in jref.sample_cutoff_masked(n, b, s, nt))
            mask = ref.sample_mask_masked_ref(n, b, seed, n_t).numpy()
            np.testing.assert_array_equal(
                mask, np.asarray(jref.sample_mask_masked_ref(n, b, s, nt)))
            assert mask.sum() == min(b, n_t)
            assert not mask[n_t:].any()


@pytest.mark.parametrize("n,b,n_t,seed", [
    (12, 4, 7, 0), (12, 4, 0, 1), (12, 12, 5, 2), (37, 9, 37, 3),
    (37, 40, 17, 4), (1, 1, 1, 5), (600, 50, 300, 6), (513, 32, 400, 7)])
def test_keep_bits_match_pallas_sample_mask(n, b, n_t, seed):
    """The Pallas kernel's own selection bits, in interpret mode."""
    want = np.asarray(jops.sample_mask(n, b, _u32(seed), n_t=jnp.int32(n_t),
                                       interpret=True))
    got = ops.sample_mask(n, ref.sample_scalars(n, b, [seed], [n_t])[0],
                          "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_keep_bit_tie_break_by_construction(seed):
    """Distinct rows never share a hash under one seed (the hash is a
    bijection of the row), so the tie branch h == cut_h is built here: the
    cut is placed ON row k's hash with cut_i below, at and above k."""
    n = 50
    h = jref.counter_hash(_u32(seed), jnp.arange(n, dtype=jnp.uint32))
    h = np.asarray(h)
    for k in (0, 17, n - 1):
        for cut_i in (max(k - 1, 0), k, n - 1):
            block = np.array([seed, h[k], cut_i, n], np.uint32)
            idx = np.arange(n, dtype=np.uint32)
            want = ((h < h[k]) | ((h == h[k]) & (idx <= cut_i))) & (idx < n)
            got = ref.keep_bits_ref(n, block).numpy()
            np.testing.assert_array_equal(got, want)
            assert got[k] == (k <= cut_i)


@pytest.mark.parametrize("seed", SEEDS)
def test_numpy_and_torch_hash_match_jax(seed):
    ctr = np.concatenate([np.arange(2048, dtype=np.uint32),
                          np.random.default_rng(1).integers(
                              0, 2**32, 2048, dtype=np.uint64).astype(
                                  np.uint32)])
    want = np.asarray(jref.counter_hash(_u32(seed), jnp.asarray(ctr)))
    np.testing.assert_array_equal(ref.counter_hash_np(seed, ctr), want)
    got = ref.counter_hash(seed, torch.from_numpy(ctr.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
