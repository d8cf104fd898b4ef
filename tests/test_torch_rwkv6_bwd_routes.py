"""The WKV backward's routes and the chunked route's plain version, on the
CPU.

`kernels/rwkv6_bwd.py` picks between two kernels: `chunked`
(csrc/rwkv6_bwd_chunked.cu, bf16 at D 64 from CHUNKED_MIN_LEN tokens) and
`recurrent` (csrc/rwkv6_bwd.cu, the rest).  Held here:

- `route` as a pure function, `accepts`, the wrapper's refusals, the
  per-route launch counts (with the library's entry points stood in by
  fakes, so that the wrapper's own logic runs on the CPU), and the launch
  `plan`, whose chunk blocks cover each (b, h, chunk) once;
- `ref.wkv_bwd_subchunk_ref`, the chunked route's factorisation step for
  step, with float32 operands against the exact gradient
  `ref.wkv_bwd_exact_ref` within 1e-5 of each gradient's max |value|
  (float32 sums in other orders; seen under 1e-6), at the model's decays,
  at w near 1e-3 and 1e-6, at w = 1 and at L 1, 5, 37, 70 and 200; in
  float64 to 1e-12; and against `jax.grad` of the reference's
  `_wkv_chunked` on the D 64 cases of test_torch_rwkv_train's GRAD_CASES
  at its RTOL;
- TF32 operands within 2e-3 and bfloat16 operands within 2e-2 of each
  gradient's max of the float32 ones (a 2^-11 and a 2^-8 rounding of
  each operand; seen: under 4e-4 and 4e-3).

The CUDA kernels are held against these plain versions on the card by
chip_smoke.py (phase 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_rwkv_train import (GRAD_CASES, RTOL, jax_grads,  # noqa: E402
                                   rel, torch_case, wkv_case)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_bwd as k_bwd  # noqa: E402

NAMES = ("dr", "dk", "dv", "dw", "du")
OPERAND_TOL = {"tf32": 2e-3, "bfloat16": 2e-2}


def decay_case(seed, b, ell, h, d, log_w0, dtype=np.float32):
    """r, k, v, do, u ~ 0.5 N; w = exp(-exp(log_w0 + 0.5 N)) as
    chip_smoke.py draws the decays (the model's init at -6, w near 1e-3 at
    1.9, near 1e-6 at 2.63), or w = 1 for log_w0 None."""
    case = list(wkv_case(seed, b, ell, h, d, 0.5, 1.0, np.float64))
    rng = np.random.default_rng(seed + 1000)
    case[3] = np.ones_like(case[3]) if log_w0 is None else np.exp(
        -np.exp(log_w0 + 0.5 * rng.standard_normal(case[3].shape)))
    return tuple(x.astype(dtype) for x in case)


def test_route_is_a_pure_function_of_dtype_length_and_head_size():
    m = k_bwd.CHUNKED_MIN_LEN
    assert k_bwd.route(torch.bfloat16, m, 64) == "chunked"
    assert k_bwd.route(torch.bfloat16, 2048, 64) == "chunked"
    assert k_bwd.route(torch.bfloat16, m - 1, 64) == "recurrent"
    assert k_bwd.route(torch.bfloat16, 1, 64) == "recurrent"
    assert k_bwd.route(torch.float32, 2048, 64) == "recurrent"
    assert k_bwd.route(torch.bfloat16, 2048, 32) == "recurrent"
    assert k_bwd.ROUTES == ("chunked", "recurrent")


def test_accepts():
    assert k_bwd.accepts("chunked", torch.bfloat16, 64)
    assert not k_bwd.accepts("chunked", torch.float32, 64)
    assert not k_bwd.accepts("chunked", torch.bfloat16, 32)
    for dt in (torch.float32, torch.bfloat16):
        for d in (32, 64):
            assert k_bwd.accepts("recurrent", dt, d)
    assert not k_bwd.accepts("recurrent", torch.float16, 64)
    assert not k_bwd.accepts("recurrent", torch.float32, 48)
    with pytest.raises(ValueError, match="route"):
        k_bwd.accepts("wgmma", torch.bfloat16, 64)


def test_wrapper_refuses_cpu_tensors_unknown_routes_and_forced_chunked():
    f32 = torch_case(wkv_case(9, 1, 20, 2, 64, 0.5, 1.0))
    bf16 = tuple(t.to(torch.bfloat16) if i in (0, 1, 2, 5) else t
                 for i, t in enumerate(f32))
    d32 = torch_case(wkv_case(9, 1, 20, 2, 32, 0.5, 1.0))
    for case in (f32, bf16, d32):
        with pytest.raises(ValueError, match="CUDA"):
            k_bwd.wkv_bwd(*case)
    with pytest.raises(ValueError, match="CUDA"):
        k_bwd.wkv_bwd(*bf16, route="chunked")
    with pytest.raises(ValueError, match="route"):
        k_bwd.wkv_bwd(*bf16, route="sm90")
    for case in (f32, d32):                 # float32, D 32
        with pytest.raises(ValueError, match="route 'chunked' does not take"):
            k_bwd.wkv_bwd(*case, route="chunked")
    assert k_bwd.route_counts() == {"chunked": 0, "recurrent": 0}


@pytest.fixture
def fake_library(monkeypatch):
    """The wrapper's device checks and the library's entry points stood in
    by fakes that accept CPU tensors and record each launch's name and
    integer arguments."""
    calls = []

    def function(name, argtypes):
        def fn(*args):
            calls.append((name, [a for a, t in zip(args, argtypes)
                                 if t.__name__ == "c_int"]))
            return 0
        return fn
    monkeypatch.setattr(_build, "require_cuda",
                        lambda name, **t: torch.device("cpu"))
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    ops.reset_launch_counts()
    yield calls
    ops.reset_launch_counts()


def test_each_route_counts_its_own_launches(fake_library):
    bf16 = tuple(t.to(torch.bfloat16) if i in (0, 1, 2, 5) else t
                 for i, t in enumerate(torch_case(
                     wkv_case(10, 2, 70, 3, 64, 0.5, 1.0))))
    short = tuple(t[:, :k_bwd.CHUNKED_MIN_LEN - 1] if t.dim() == 4 else t
                  for t in bf16)
    f32 = torch_case(wkv_case(11, 1, 40, 2, 32, 0.5, 1.0))
    k_bwd.wkv_bwd(*bf16)
    k_bwd.wkv_bwd(*(t.contiguous() for t in short))
    k_bwd.wkv_bwd(*f32)
    k_bwd.wkv_bwd(*bf16, route="recurrent")
    k_bwd.wkv_bwd(*bf16, route="chunked")
    assert k_bwd.route_counts() == {"chunked": 2, "recurrent": 3}
    assert k_bwd.launches == 5
    assert [c[0] for c in fake_library] == [
        "rwkv6_bwd_chunked_launch", "rwkv6_bwd_launch", "rwkv6_bwd_launch",
        "rwkv6_bwd_launch", "rwkv6_bwd_chunked_launch"]
    pl = k_bwd.plan(2, 70, 3, 64)
    assert fake_library[0][1] == [2, 70, 3, 64, pl.states_grid,
                                  pl.chunk_grid, pl.threads,
                                  pl.states_smem, pl.smem]
    assert fake_library[1][1] == [1, 2, k_bwd.CHUNKED_MIN_LEN - 1, 3, 64]
    ops.reset_launch_counts()
    assert k_bwd.route_counts() == {"chunked": 0, "recurrent": 0}
    assert k_bwd.launches == 0


@pytest.mark.parametrize("b,ell,h", [(2, 2048, 40), (1, 1, 1), (2, 65, 3),
                                     (1, 200, 2), (3, 64, 5)])
def test_plan_covers_each_chunk_once(b, ell, h):
    pl = k_bwd.plan(b, ell, h, 64)
    nc = -(-ell // 64)
    assert pl.states_grid == 2 * b * h and pl.chunk_grid == b * h * nc
    assert pl.threads == 256 and pl.chunk == 64 and pl.sub == 16
    blocks = k_bwd.block_chunks(pl, h)
    assert blocks.shape == (b * h * nc, 4)
    seen = {tuple(x) for x in blocks[:, :3].tolist()}
    assert seen == {(i, j, c) for i in range(b) for j in range(h)
                    for c in range(nc)}
    assert (blocks[:, 3] == 64 * blocks[:, 2]).all()
    assert (blocks[:, 3] < ell).all()
    shapes = k_bwd.chunked_scratch_shapes(b, ell, h, 64)
    assert pl.scratch_bytes == 4 * sum(int(np.prod(s))
                                       for s in shapes.values())
    assert pl.states_smem == 89344 and pl.smem == 231424
    assert 2 * pl.states_smem <= 228 * 1024 and pl.smem <= 232448
    with pytest.raises(ValueError, match="plan"):
        k_bwd.plan(b, ell, h, 32)


def test_training_shape_scratch_is_a_quarter_of_the_recurrent_routes():
    pl = k_bwd.plan(2, 2048, 40, 64)
    assert pl.scratch_bytes == 84541440            # 84.5 MB
    ckpt = k_bwd.scratch_shapes(2, 2048, 40, 64)["ckpt"]
    assert 4 * int(np.prod(ckpt)) == 335544320     # 335.5 MB


def _check_float32(case):
    exact = ref.wkv_bwd_exact_ref(*torch_case(case))
    got = ref.wkv_bwd_subchunk_ref(*torch_case(case), operands="float32")
    for name, g, e in zip(NAMES, got, exact):
        assert g.dtype == torch.float32 and g.shape == e.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert rel(g, e) <= RTOL, name


@pytest.mark.parametrize("log_w0", [-6.0, 1.9, 2.63, None],
                         ids=["model", "w~1e-3", "w~1e-6", "w=1"])
def test_subchunk_form_matches_the_exact_gradient_at_edge_decays(log_w0):
    _check_float32(decay_case(21, 2, 100, 3, 64, log_w0))


@pytest.mark.parametrize("ell", [1, 5, 37, 70, 200])
def test_subchunk_form_matches_the_exact_gradient_by_length(ell):
    _check_float32(decay_case(ell, 2, ell, 2, 64, -1.0))


@pytest.mark.parametrize("log_w0", [-6.0, 2.63, None],
                         ids=["model", "w~1e-6", "w=1"])
def test_subchunk_form_is_the_gradient_in_float64(log_w0):
    case = decay_case(31, 1, 150, 2, 16, log_w0, np.float64)
    exact = ref.wkv_bwd_exact_ref(*torch_case(case))
    got = ref.wkv_bwd_subchunk_ref(*torch_case(case), operands="float32")
    for name, g, e in zip(NAMES, got, exact):
        assert g.dtype == torch.float64, name
        assert rel(g, e) <= 1e-12, name
    with pytest.raises(ValueError, match="float64"):
        ref.wkv_bwd_subchunk_ref(*torch_case(case), operands="tf32")


D64_GRAD_CASES = [c for c in GRAD_CASES if c[4] == 64]


@pytest.mark.parametrize("seed,b,ell,h,d,wr,chunk", D64_GRAD_CASES)
def test_subchunk_form_matches_jax_grad_of_wkv_chunked(seed, b, ell, h, d,
                                                       wr, chunk):
    case = wkv_case(seed, b, ell, h, d, *wr)
    got = ref.wkv_bwd_subchunk_ref(*torch_case(case), operands="float32")
    for name, g, want in zip(NAMES, got, jax_grads(case, chunk)):
        assert rel(g, want) <= RTOL, name


@pytest.mark.parametrize("operands", ["tf32", "bfloat16"])
@pytest.mark.parametrize("log_w0", [-6.0, 2.63], ids=["model", "w~1e-6"])
def test_rounded_operands_stay_near_float32(operands, log_w0):
    """bf16 r, k, v, do as the kernel takes them; the operands' rounding
    against the float32 form."""
    case = torch_case(decay_case(41, 2, 150, 3, 64, log_w0))
    case = tuple(t.to(torch.bfloat16) if i in (0, 1, 2, 5) else t
                 for i, t in enumerate(case))
    want = ref.wkv_bwd_subchunk_ref(*case, operands="float32")
    got = ref.wkv_bwd_subchunk_ref(*case, operands=operands)
    for name, g, w in zip(NAMES, got, want):
        if g.dtype == torch.bfloat16:     # both rounded once to bf16
            assert rel(g, w) <= OPERAND_TOL[operands] + 2.0 ** -8, name
        else:
            assert rel(g, w) <= OPERAND_TOL[operands], name


def test_stage_tool_finds_its_markers():
    """launch/wkv_bwd_stages.py stamps the chunk kernel by its source text:
    a stamp after each of its barriers, and the stamp array at file
    scope."""
    from repro_torch.launch import wkv_bwd_stages as stages
    src = (_build.CSRC / "rwkv6_bwd_chunked.cu").read_text()
    body = src[src.index(stages.KERNEL):src.index("// ---- launch 3")]
    out = stages.stamped(src, 4)
    assert out.count("__syncthreads(); if (tid == 0) g_stamps") \
        == body.count("__syncthreads();") == 6
    assert out.index("g_stamps[128]") < out.index("namespace {")
    with pytest.raises(SystemExit, match="no longer holds"):
        stages.stamped(src.replace(stages.TAIL, ""), 4)
