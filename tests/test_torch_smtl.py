"""The port's synchronous solvers (`repro_torch.core.smtl`) against the
reference's on the same numpy-seeded problem, for the l2,1 and nuclear
formulations.

Tolerances: objectives within OBJ_RTOL relative and W within W_RTOL of
its scale — each iteration's full gradient is a float32 matrix product
summed in another order, and the prox rounds apart (SVD; the l2,1 row
norms), so the iterates drift by float32 rounding.  On the card
chip_smoke.py holds FISTA against the port's CPU run the same way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import smtl as jsmtl  # noqa: E402
from repro.core.losses import MTLProblem as JProblem  # noqa: E402
import repro_torch as rt  # noqa: E402
from repro_torch.core import smtl  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

OBJ_RTOL = 1e-5
W_RTOL = 1e-4


@pytest.fixture(scope="module", params=["l21", "nuclear"])
def problems(request):
    rng = np.random.default_rng(12)
    xs = rng.standard_normal((5, 40, 16)).astype(np.float32)
    w_star = (rng.standard_normal((16, 2))
              @ rng.standard_normal((2, 5))).astype(np.float32)
    w_star[::4] = 0.0
    ys = (np.einsum("tnd,dt->tn", xs, w_star)
          + 0.1 * rng.standard_normal((5, 40))).astype(np.float32)
    jp = JProblem(jnp.asarray(xs), jnp.asarray(ys), "lstsq", request.param,
                  2.0)
    tp = rt.problem_from_numpy(xs, ys, "lstsq", request.param, 2.0,
                               device="cpu")
    return jp, tp


def _assert_result(got, want):
    np.testing.assert_allclose(got.objectives.numpy(),
                               np.asarray(want.objectives), rtol=OBJ_RTOL)
    w = np.asarray(want.w)
    assert np.abs(got.w.numpy() - w).max() <= W_RTOL * np.abs(w).max()
    np.testing.assert_allclose(got.residuals.numpy(),
                               np.asarray(want.residuals), rtol=1e-3,
                               atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("solver", ["smtl_solve", "fista_solve"])
def test_solver_matches_jax(problems, solver):
    jp, tp = problems
    eta = 1.0 / jp.lipschitz()
    w0 = np.full((16, 5), 0.1, np.float32)
    want = getattr(jsmtl, solver)(jp, jnp.asarray(w0), eta, 40)
    got = getattr(smtl, solver)(tp, w0, eta, 40, device="cpu")
    assert got.objectives.shape == (40,) and got.residuals.shape == (40,)
    _assert_result(got, want)


def test_reference_optimum_matches_jax(problems):
    jp, tp = problems
    w_j, obj_j = jsmtl.reference_optimum(jp, num_iters=300)
    ops.reset_launch_counts()
    w_t, obj_t = rt.reference_optimum(tp, num_iters=300, device="cpu")
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    np.testing.assert_allclose(float(obj_t), float(obj_j), rtol=OBJ_RTOL)
    w = np.asarray(w_j)
    assert np.abs(w_t.numpy() - w).max() <= W_RTOL * np.abs(w).max()
    # an optimum: the proximal-gradient map moves it by rounding only
    step = rt.core.forward_backward(tp, w_t, 1.0 / tp.lipschitz())
    assert float(torch.linalg.vector_norm(step - w_t)) \
        <= 1e-4 * float(torch.linalg.vector_norm(w_t))


def test_solvers_need_the_problems_device(problems):
    _, tp = problems
    w0 = np.zeros((16, 5), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.fista_solve(tp, w0, 0.01, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.reference_optimum(tp, num_iters=2)
    empty = rt.smtl_solve(tp, w0, 0.01, 0, device="cpu")
    assert empty.objectives.shape == (0,)
    assert torch.equal(empty.w, torch.from_numpy(w0))
