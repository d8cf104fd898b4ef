"""The launch plans of the randomized-SVT kernels, and their plain versions
at the plans' edge shapes, on the CPU.

`gauss_sketch.plan(d, t, p)` and `svt_reconstruct.plan(d, p, m)` are pure
host functions that the wrappers pass to the CUDA kernels: each block owns
the output tile that `block_tiles` derives from its block index, as the
kernel does.  Held here: the tiles cover every output element exactly
once, and each plan stays within a block's shared memory on Hopper
(232,448 bytes) and its budget of values a thread holds in registers.  The plain versions
(`ops.gauss_sketch`, `ops.svt_reconstruct` on CPU tensors) are held
against the JAX kernels in interpret mode at p 257 (past one chunk of the
kernels' columns) and m 300 (past one column tile), with the tolerances of
tests/test_torch_kernels_ref.py: 1e-5 of the sum of |terms| (float32 log,
cos and sums in another order).  The CUDA kernels are held against these
plain versions on the card by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import gauss_sketch as k_sketch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import svt_reconstruct as k_recon  # noqa: E402

SKETCH_RTOL = 1e-5
RECON_RTOL = 1e-5
MAX_SMEM = 232448          # dynamic shared memory a block may take on Hopper
SMS = 132                  # the H100 SXM's SMs

PLAN_D = (1, 7, 1000, 8192, 8193)
PLAN_T = (1, 100, 128, 300, 4096)      # t for the sketch, m for the apply
PLAN_P = (1, 7, 24, 256, 257)


def _coverage(tiles: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """How many blocks' tiles hold each element of a (rows, cols) output."""
    count = np.zeros((rows, cols), np.int32)
    for r0, r1, c0, c1 in tiles:
        count[r0:r1, c0:c1] += 1       # an empty tile (r1 <= r0) adds nothing
    return count


@pytest.mark.parametrize("p", PLAN_P)
@pytest.mark.parametrize("d", PLAN_D)
def test_sketch_plan_covers_each_output_once(d, p):
    for t in PLAN_T:
        pl = k_sketch.plan(d, t, p, SMS)
        tiles = k_sketch.block_tiles(pl, d, p)
        assert np.all(_coverage(tiles, d, p) == 1), (d, t, p, pl)
        # every block holds at least one row and one column
        assert np.all(tiles[:, 1] > tiles[:, 0]) and np.all(
            tiles[:, 3] > tiles[:, 2]), pl
        assert pl.rows_per_thread in k_sketch.ROWS_PER_THREAD, pl
        assert pl.smem <= MAX_SMEM, pl
        assert pl.held_values <= k_sketch.HELD_BUDGET, pl


@pytest.mark.parametrize("p", PLAN_P)
@pytest.mark.parametrize("d", PLAN_D)
def test_recon_plan_covers_each_output_once(d, p):
    for m in PLAN_T:
        pl = k_recon.plan(d, p, m, SMS)
        tiles = k_recon.block_tiles(pl, d, m)
        assert np.all(_coverage(tiles, d, m) == 1), (d, p, m, pl)
        assert np.all(tiles[:, 1] > tiles[:, 0]) and np.all(
            tiles[:, 3] > tiles[:, 2]), pl
        # the block's warps walk rows_per_block rows, its lanes 128 columns
        assert pl.rows_per_block % k_recon.WARPS == 0, pl
        assert pl.p_chunk in k_recon.P_CHUNKS and pl.p_chunk >= min(p, 32)
        assert pl.smem <= MAX_SMEM, pl
        assert pl.held_values <= k_recon.HELD_BUDGET, pl


@pytest.mark.parametrize("kernel", ["sketch", "recon"])
def test_plan_main_shape(kernel):
    """The batch cell's prox (d 8192, T 128, p 24) fills the card's 132
    SMs with about one block each."""
    if kernel == "sketch":
        pl = k_sketch.plan(8192, 128, 24, SMS)
    else:
        pl = k_recon.plan(8192, 24, 128, SMS)
    blocks = pl.grid[0] * pl.grid[1]
    assert 0.9 * SMS <= blocks <= SMS, pl


@pytest.mark.parametrize("d,t,p,off", [
    (32, 40, 257, 5),
    (17, 100, 257, 2**32 // 257 - 50),     # counters wrap past 2^32
    (32, 300, 7, 5),
])
def test_gauss_sketch_plain_vs_jax_interpret(d, t, p, off):
    rng = np.random.default_rng(d * t + p)
    w = rng.standard_normal((d, t)).astype(np.float32)
    seed = 0xBEEF + p
    omega = np.asarray(jref.gauss_omega_ref(t, p, jnp.uint32(seed), off))
    scale = np.abs(w) @ np.abs(omega)
    got = ops.gauss_sketch(torch.from_numpy(w), seed, off, p).numpy()
    want = np.asarray(jops.gauss_sketch(w, jnp.uint32(seed), jnp.int32(off),
                                        p=p, interpret=True))
    assert got.shape == want.shape == (d, p)
    assert np.all(np.abs(got - want) <= SKETCH_RTOL * scale)


@pytest.mark.parametrize("d,p,m", [(32, 24, 300), (17, 257, 300),
                                   (32, 257, 128)])
def test_svt_reconstruct_plain_vs_jax_interpret(d, p, m):
    rng = np.random.default_rng(d * p + m)
    qu = rng.standard_normal((d, p)).astype(np.float32)
    s = (rng.random(p) * 3.0).astype(np.float32)
    s[1] = 0.0
    vt = rng.standard_normal((p, m)).astype(np.float32)
    got = ops.svt_reconstruct(torch.from_numpy(qu), torch.from_numpy(s),
                              torch.from_numpy(vt)).numpy()
    want = np.asarray(jops.svt_reconstruct(qu, s, vt, interpret=True))
    scale = (np.abs(qu) * s) @ np.abs(vt)
    assert got.shape == want.shape == (d, m)
    assert np.all(np.abs(got - want) <= RECON_RTOL * scale + 1e-30)
