"""The KM block update's plain version (`ref.km_update_ref`, which
`ops.km_update` and `operators.km_block_update` run on the CPU) against
the reference's Pallas `km_update` in interpret mode, on the same
numpy-seeded inputs.

float32 is bitwise: the plain version forms the two fmas XLA's CPU
backend emits for v + eta_k*(p - eta*g - v), and the CUDA kernel writes
the same two `__fmaf_rn` (held bitwise on the card by chip_smoke.py,
phase 3).  bf16 is held as tests/test_kernels.py holds the Pallas kernel:
within 2e-2 of the float32 update of the upcast inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.km_update import km_update as pallas_km  # noqa: E402
from repro_torch.core.operators import km_block_update  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ETA, ETA_K = 0.05, 0.8
# tests/test_kernels.py's shapes, plus the dense engine's (8192, 1) column
# and the kernels bench's (8192, 128)
SHAPES = [(8, 4), (50, 20), (256, 128), (300, 130), (1000, 16), (7, 1),
          (8192, 1), (8192, 128)]


def _vpg(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _pallas(v, p, g, dtype=jnp.float32):
    return pallas_km(*(jnp.asarray(a).astype(dtype) for a in (v, p, g)),
                     jnp.asarray(ETA), jnp.asarray(ETA_K), interpret=True)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{d}x{t}" for d, t in SHAPES])
def test_float32_bitwise_pallas_interpret(shape):
    v, p, g = _vpg(shape, shape[0] + 31 * shape[1])
    want = np.asarray(_pallas(v, p, g))
    got = ops.km_update(*(torch.from_numpy(a) for a in (v, p, g)), ETA,
                        ETA_K).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{d}x{t}" for d, t in SHAPES])
def test_bfloat16_as_the_jax_test_holds_it(shape):
    v, p, g = _vpg(shape, shape[0] + 17 * shape[1])
    tv, tp, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (v, p, g))
    got = ops.km_update(tv, tp, tg, ETA, ETA_K)
    assert got.dtype == torch.bfloat16
    # the reference's own check, on the same bf16-rounded inputs
    up = [t.float().numpy() for t in (tv, tp, tg)]
    want = np.asarray(jref.km_update_ref(*(jnp.asarray(a) for a in up),
                                         jnp.asarray(ETA),
                                         jnp.asarray(ETA_K)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    pal = np.asarray(_pallas(*up, dtype=jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), pal, rtol=2e-2,
                               atol=2e-2)


def test_km_block_update_is_the_kernels_function():
    """The dense engine's column update, on a (d,) column, is bitwise the
    Pallas kernel on the (d, 1) block and `ops.km_update`."""
    v, p, g = _vpg((8192, 1), 5)
    cols = [torch.from_numpy(a[:, 0].copy()) for a in (v, p, g)]
    got = km_block_update(*cols, ETA, ETA_K)
    assert torch.equal(got, ops.km_update(*cols, ETA, ETA_K))
    assert torch.equal(got, ref.amtl_event_ref(*cols, ETA, ETA_K)[0])
    want = np.asarray(_pallas(v, p, g))[:, 0]
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_cpu_tensors_launch_nothing():
    ops.reset_launch_counts()
    v, p, g = (torch.from_numpy(a) for a in _vpg((64, 3), 6))
    ops.km_update(v, p, g, ETA, ETA_K)
    km_block_update(v[:, 0].contiguous(), p[:, 0].contiguous(),
                    g[:, 0].contiguous(), ETA, ETA_K)
    assert ops.launch_counts()["km_update"] == 0
