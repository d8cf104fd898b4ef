"""The port's plain kernel versions (`repro_torch.kernels.ref`) against the
reference's oracles (`repro.kernels.ref`) and its Pallas kernels run in
interpret mode, on the same numpy-seeded inputs.

Bitwise: the counter hash, the KM column updates and every undo entry.
The KM update is the reference's fma form on both sides (XLA's CPU
backend contracts `v + eta_k*(p - eta*g - v)` into two fmas; the port
forms the same fmas exactly), so it matches bit for bit.  The sketch and
the reconstruction are held to a tolerance: PyTorch's float32 log/cos and
matmul summation order are not XLA's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# Sketch entries: Box-Muller through float32 log/cos/sqrt that differ by an
# ulp or two between the libraries, summed over a T-term product whose
# order differs too: 1e-5 of the sum of |w||omega| bounds both.
SKETCH_RTOL = 1e-5
# Omega entries (|z| < 6): XLA's and PyTorch's float32 log/cos are
# different approximations, a few ulps apart; 1e-5 is ~20 ulps at |z| = 4.
OMEGA_ATOL = 1e-5
# Reconstruction: one rounding per term of a p-term sum in another order.
RECON_RTOL = 1e-5


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _t(a) -> "torch.Tensor":
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B9, 0xFFFFFFFF, 123456789])
def test_counter_hash_bitwise(seed):
    rng = np.random.default_rng(seed % 1000)
    ctr = np.concatenate([np.arange(4096, dtype=np.uint64),
                          rng.integers(0, 2**32, 4096, dtype=np.uint64)])
    want = np.asarray(jref.counter_hash(jnp.uint32(seed),
                                        jnp.asarray(ctr.astype(np.uint32))))
    got = ref.counter_hash(seed, torch.from_numpy(ctr.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("d", [1, 7, 1000, 65536])
@pytest.mark.parametrize("eta,eta_k", [(0.05, 0.37), (0.013, 0.999),
                                       (1.7, 0.0)])
def test_amtl_event_bitwise(d, eta, eta_k):
    rng = np.random.default_rng(d)
    v, p, g = (rng.standard_normal(d).astype(np.float32) for _ in range(3))
    # jitted, as the engines run it: op-by-op JAX rounds each operation
    # on its own and does not form the fmas.
    want_v, want_old = jax.jit(jref.amtl_event_ref)(
        v, p, g, jnp.float32(eta), jnp.float32(eta_k))
    got_v, got_old = ops.amtl_event(_t(v), _t(p), _t(g), eta, eta_k)
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
    np.testing.assert_array_equal(_bits(got_old), _bits(v))
    np.testing.assert_array_equal(_bits(want_old), _bits(v))
    if d <= 1000:
        kv, kold = jops.amtl_event(v, p, g, jnp.float32(eta),
                                   jnp.float32(eta_k), interpret=True)
        np.testing.assert_array_equal(_bits(got_v), _bits(kv))
        np.testing.assert_array_equal(_bits(got_old), _bits(kold))


def test_km_update_fma_form_bitwise_over_many_elements():
    """The measurement behind the fma form: 2**18 random float32 triples,
    the reference's jitted expression against the port's exact fmas."""
    rng = np.random.default_rng(7)
    v, p, g = (rng.standard_normal(1 << 18).astype(np.float32)
               for _ in range(3))
    want = jax.jit(jref.km_update_ref)(v, p, g, jnp.float32(0.05),
                                       jnp.float32(0.7))
    got = ref.km_update_ref(_t(v), _t(p), _t(g), 0.05, 0.7)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("d,num_t,b", [(20, 6, 10), (300, 130, 16),
                                       (64, 3, 12), (9, 1, 5)])
def test_amtl_event_batch_bitwise(d, num_t, b):
    """Duplicate tasks and B > T serialize in event order; undo bits exact."""
    rng = np.random.default_rng(d + num_t)
    v = rng.standard_normal((d, num_t)).astype(np.float32)
    p, g = (rng.standard_normal((d, b)).astype(np.float32) for _ in range(2))
    tasks = rng.integers(0, num_t, b).astype(np.int32)
    eks = rng.random(b).astype(np.float32)
    eks[b // 2] = 0.0
    want_v, want_u = jref.amtl_event_batch_ref(
        jnp.asarray(v), jnp.asarray(p), jnp.asarray(g), jnp.asarray(tasks),
        jnp.float32(0.05), jnp.asarray(eks))
    got_v, got_u = ops.amtl_event_batch(_t(v), _t(p), _t(g), _t(tasks), 0.05,
                                        _t(eks))
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
    np.testing.assert_array_equal(_bits(got_u), _bits(want_u))
    kv, ku = jops.amtl_event_batch(v, p, g, tasks, jnp.float32(0.05), eks,
                                   interpret=True)
    np.testing.assert_array_equal(_bits(got_v), _bits(kv))
    np.testing.assert_array_equal(_bits(got_u), _bits(ku))


def test_amtl_event_batch_sentinel_ids_dropped_bitwise():
    """Ids >= T (the sharded engine's sentinel) never write V; their undo
    entries follow the reference's clamped gather, duplicates chained."""
    rng = np.random.default_rng(3)
    d, num_t, b = 50, 4, 12
    v = rng.standard_normal((d, num_t)).astype(np.float32)
    p, g = (rng.standard_normal((d, b)).astype(np.float32) for _ in range(2))
    tasks = np.array([2, 4, 3, 4, 3, 0, 4, 3, 1, 2, 4, 3], np.int32)
    eks = rng.random(b).astype(np.float32)
    want_v, want_u = jref.amtl_event_batch_ref(
        jnp.asarray(v), jnp.asarray(p), jnp.asarray(g), jnp.asarray(tasks),
        jnp.float32(0.05), jnp.asarray(eks))
    got_v, got_u = ops.amtl_event_batch(_t(v), _t(p), _t(g), _t(tasks), 0.05,
                                        _t(eks))
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
    np.testing.assert_array_equal(_bits(got_u), _bits(want_u))


def test_amtl_event_batch_updates_in_place():
    v = torch.zeros((4, 3))
    out, _ = ops.amtl_event_batch(v, torch.ones((4, 2)), torch.zeros((4, 2)),
                                  torch.tensor([1, 1], dtype=torch.int32),
                                  0.1, torch.tensor([0.5, 0.5]))
    assert out is v
    np.testing.assert_array_equal(v[:, 1].numpy(), np.full(4, 0.75, np.float32))


def test_last_occurrence_mask_matches():
    tasks = np.array([3, 1, 3, 0, 1, 1, 2], np.int32)
    np.testing.assert_array_equal(
        ref.last_occurrence_mask(_t(tasks)).numpy(),
        np.asarray(jref.last_occurrence_mask(jnp.asarray(tasks))))


@pytest.mark.parametrize("rows,p,off", [(128, 24, 0), (100, 7, 5),
                                        (3, 1, 1000)])
def test_gauss_omega_and_sketch(rows, p, off):
    seed = 0xC0FFEE + rows
    want = np.asarray(jref.gauss_omega_ref(rows, p, jnp.uint32(seed), off))
    got = ref.gauss_omega_ref(rows, p, seed, off).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OMEGA_ATOL)

    rng = np.random.default_rng(rows)
    w = rng.standard_normal((40, rows)).astype(np.float32)
    scale = np.abs(w) @ np.abs(want)
    got_s = ref.gauss_sketch_ref(_t(w), seed, off, p).numpy()
    for other in (jref.gauss_sketch_ref(w, jnp.uint32(seed), off, p),
                  jops.gauss_sketch(w, jnp.uint32(seed), jnp.int32(off), p=p,
                                    interpret=True)):
        assert np.all(np.abs(got_s - np.asarray(other)) <= SKETCH_RTOL * scale)


@pytest.mark.parametrize("d,p,m", [(64, 24, 128), (300, 7, 16), (7, 1, 1)])
def test_svt_reconstruct(d, p, m):
    rng = np.random.default_rng(d * p)
    qu = rng.standard_normal((d, p)).astype(np.float32)
    s = (rng.random(p) * 3.0).astype(np.float32)
    s[0] = 0.0
    vt = rng.standard_normal((p, m)).astype(np.float32)
    got = ops.svt_reconstruct(_t(qu), _t(s), _t(vt)).numpy()
    scale = (np.abs(qu) * s) @ np.abs(vt)
    for other in (jref.svt_reconstruct_ref(qu, s, vt),
                  jops.svt_reconstruct(qu, s, vt, interpret=True)):
        assert np.all(np.abs(got - np.asarray(other))
                      <= RECON_RTOL * scale + 1e-30)
