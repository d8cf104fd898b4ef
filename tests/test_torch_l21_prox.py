"""The l2,1 prox's plain version (`ref.l21_prox_ref`, which `ops.l21_prox`
and `prox.l21_prox` run on the CPU) against the reference's Pallas kernel
in interpret mode and its jnp prox, on the same numpy-seeded inputs.

Tolerances: float32 within L21_RTOL of max|w| — the two sum a row's
squares in another order, and the Pallas kernel differs from the port by
up to one ulp of the output (4.8e-7 at max|out| 3.6); bf16 within one bf16
ulp of the output, since both compute in float32 and round once.
The CUDA kernel is held to the same plain version on the card by
chip_smoke.py (phase 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import prox as jprox  # noqa: E402
from repro.kernels.l21_prox import l21_prox as pallas_l21  # noqa: E402
from repro_torch.core import prox  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

L21_RTOL = 1e-6
# tests/test_kernels.py's shapes, plus the engine's (d 8192, T 128)
SHAPES = [(8, 4), (50, 20), (512, 128), (600, 7), (1, 1), (1023, 3),
          (8192, 128)]


def _w(shape, seed, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(w32: np.ndarray, dtype: str):
    """The same bits as a JAX and a torch array of `dtype`."""
    jw = jnp.asarray(w32).astype(getattr(jnp, dtype))
    tw = torch.from_numpy(w32).to(getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(jw.astype(jnp.float32)),
                                  tw.float().numpy())
    return jw, tw


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of |x| (8 significant bits)."""
    _, e = np.frexp(np.maximum(np.abs(x), np.finfo(np.float32).tiny))
    return np.ldexp(1.0, e - 8)


def _assert_close(got: torch.Tensor, want, w32: np.ndarray, dtype: str):
    g = got.float().numpy().astype(np.float64)
    r = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    err = np.abs(g - r)
    if dtype == "float32":
        assert err.max(initial=0.0) <= L21_RTOL * np.abs(w32).max(), \
            err.max()
    else:
        assert np.all(err <= _bf16_ulp(np.maximum(np.abs(g), np.abs(r)))), \
            err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{d}x{t}" for d, t in SHAPES])
def test_plain_matches_pallas_interpret(shape, dtype):
    w32 = _w(shape, shape[0] * 7 + shape[1])
    jw, tw = _both(w32, dtype)
    got = ops.l21_prox(tw, 0.5)
    assert got.dtype == tw.dtype and got.shape == tw.shape
    _assert_close(got, pallas_l21(jw, jnp.asarray(0.5), interpret=True),
                  w32, dtype)


@pytest.mark.parametrize("case", ["zero_rows", "t0", "t_above_norms"])
def test_edge_cases_match_pallas(case):
    w32 = _w((600, 7), 3)
    t = 0.5
    if case == "zero_rows":
        w32[[0, 5, 599]] = 0.0
    elif case == "t0":
        t = 0.0
    else:
        t = float(np.linalg.norm(w32, axis=1).max()) * 1.01
    got = ops.l21_prox(torch.from_numpy(w32), t)
    want = pallas_l21(jnp.asarray(w32), jnp.asarray(t, jnp.float32),
                      interpret=True)
    _assert_close(got, want, w32, "float32")
    if case == "zero_rows":
        assert not got[[0, 5, 599]].any()
    elif case == "t0":
        assert torch.equal(got, torch.from_numpy(w32))   # w exactly
    else:
        assert not got.any() and not np.asarray(want).any()


def test_core_prox_dispatches_to_plain_version_on_cpu():
    """`prox.l21_prox` (the registry's 'l21' prox) is `ops.l21_prox`: on a
    CPU tensor the plain version, bitwise; against the reference's jnp
    prox within L21_RTOL of scale."""
    w32 = _w((100, 10), 2, scale=1.0)
    tw = torch.from_numpy(w32)
    got = prox.l21_prox(tw, 0.3)
    assert torch.equal(got, ref.l21_prox_ref(tw, 0.3))
    assert torch.equal(prox.get_regularizer("l21").prox(tw, 0.3), got)
    _assert_close(got, jprox.l21_prox(jnp.asarray(w32), 0.3), w32, "float32")
    # a non-contiguous view is taken as its contiguous copy
    assert torch.equal(prox.l21_prox(tw.T.contiguous().T, 0.3), got)


def test_cpu_tensors_launch_nothing():
    ops.reset_launch_counts()
    w = torch.from_numpy(_w((64, 9), 4))
    ops.l21_prox(w, 0.2)
    prox.l21_prox(w.to(torch.bfloat16), 0.2)
    assert ops.launch_counts()["l21_prox"] == 0
