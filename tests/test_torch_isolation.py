"""The port stands alone: it imports neither JAX nor the reference package,
runs on the card unless asked for the CPU, and never falls back.

The import check runs in a subprocess, because this test process already
holds JAX (tests/conftest.py imports it).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import make_engine, AMTLConfig  # noqa: E402
from repro_torch import checkpoint  # noqa: E402,F401
from repro_torch import serve as amtl_serve  # noqa: E402
from repro_torch.interop import problem_from_numpy  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import amtl_event as k_event  # noqa: E402
from repro_torch.kernels import amtl_event_batch as k_batch  # noqa: E402
from repro_torch.kernels import flash_attention as k_flash  # noqa: E402
from repro_torch.kernels import gauss_sketch as k_sketch  # noqa: E402
from repro_torch.kernels import km_update as k_km  # noqa: E402
from repro_torch.kernels import l21_prox as k_l21  # noqa: E402
from repro_torch.kernels import lstsq_grad as k_grad  # noqa: E402
from repro_torch.kernels import lstsq_grad_sampled as k_sampled  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as k_rwkv  # noqa: E402
from repro_torch.kernels import sample_mask as k_mask  # noqa: E402
from repro_torch.kernels import svt_reconstruct as k_recon  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CHIP_SMOKE = SRC.parent / "chip_smoke.py"

_CHILD = """
import sys
import numpy as np
import repro_torch as rt
p = rt.problem_from_numpy(np.ones((3, 4, 5)), np.ones((3, 4)), "lstsq",
                          "nuclear", 0.1, device="cpu")
r = rt.stack_ragged([np.ones((2, 5)), np.ones((4, 5)), np.ones((1, 5))],
                    [np.ones(2), np.ones(4), np.ones(1)], "logistic",
                    "nuclear", 0.1, device="cpu")
for q, kw in ((p, dict(engine="delta", prox_every=2, prox_rank=2)),
              (p, dict(engine="batch", event_batch=2, prox_every=2)),
              (r, dict(engine="delta", batch_size=2)),
              (r, dict(engine="batch", event_batch=2, prox_every=2,
                       batch_size=1)),
              (p._replace(reg_name="l21"), dict(engine="dense")),
              (p._replace(reg_name="l21"), dict(engine="batch",
                                                event_batch=2,
                                                prox_every=2)),
              (p, dict(engine="sharded", event_batch=2, prox_every=2,
                       prox_rank=2, prox_mode="distributed")),
              (r, dict(engine="sharded", event_batch=2, prox_every=4,
                       batch_size=1))):
    e = rt.make_engine(q, rt.AMTLConfig(eta=0.01, eta_k=0.5, tau=2, **kw),
                       device="cpu")
    e.run(e.init(np.zeros((5, 3), np.float32), np.array([0, 1], np.uint32)),
          None, 4)
rt.reference_optimum(p._replace(reg_name="l21"), eta=0.01, num_iters=3,
                     device="cpu")
import repro_torch.checkpoint
import repro_torch.distributed
import repro_torch.serve
from repro_torch.launch import amtl_sharded, mesh, serve_amtl
serve_amtl.main(["--device", "cpu"])
from repro_torch.launch import serve
serve.main(["--arch", "gemma2-2b", "--reduced", "--device", "cpu",
            "--batch", "1", "--prompt-len", "5", "--gen", "2"])
serve.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
            "--batch", "1", "--prompt-len", "5", "--gen", "2"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("loaded:" + ",".join(bad))
"""


def test_import_and_cpu_engine_load_no_jax_or_reference():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2].startswith("  req0:"), out.stdout
    assert lines[-1] == "loaded:", lines[-1]


def test_sources_name_no_jax_or_reference():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path}: imports {n}"


def test_chip_smoke_names_no_jax_or_reference():
    for node in ast.walk(ast.parse(CHIP_SMOKE.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"chip_smoke.py imports {n}"


def test_lm_entry_points_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    for arch in ("gemma2-2b", "rwkv6-3b"):
        cfg = get_config(arch).reduced()
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(cfg, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", arch, "--reduced", "--batch", "1",
                        "--prompt-len", "4", "--gen", "2"])
        assert init_params(cfg, device="cpu").device.type == "cpu"


def test_unported_archs_raise_naming_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("zamba2-7b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_make_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    p = problem_from_numpy(np.ones((2, 3, 4)), np.ones((2, 3)), "lstsq",
                           "nuclear", 0.1, device="cpu")
    cfg = AMTLConfig(eta=0.01, eta_k=0.5, tau=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(p, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(p, cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(p._replace(reg_name="l21"), cfg._replace(engine="dense"))
    with pytest.raises(RuntimeError, match="CUDA"):
        problem_from_numpy(np.ones((2, 3, 4)), np.ones((2, 3)), "lstsq",
                           "nuclear", 0.1)


def test_server_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    p = problem_from_numpy(np.ones((2, 3, 4)), np.ones((2, 3)), "lstsq",
                           "nuclear", 0.1, device="cpu")
    cfg = AMTLConfig(eta=0.01, eta_k=0.5, tau=1)
    w0, key = np.zeros((4, 2), np.float32), np.zeros(2, np.uint32)
    with pytest.raises(RuntimeError, match="CUDA"):
        amtl_serve.AMTLServer(p, cfg, w0, key)
    with pytest.raises(RuntimeError, match="CUDA"):
        amtl_serve.AMTLServer.resume(p, cfg, w0, key, device="cuda")
    server = amtl_serve.AMTLServer(p, cfg, w0, key, device="cpu")
    assert server.iterate().device.type == "cpu"


def test_cpu_tensors_take_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    v = torch.randn(16, 4)
    ops.amtl_event(v[:, 0].contiguous(), v[:, 1].contiguous(),
                   v[:, 2].contiguous(), 0.1, 0.5)
    ops.amtl_event_batch(v.clone(), torch.randn(16, 3), torch.randn(16, 3),
                         torch.tensor([0, 2, 0], dtype=torch.int32), 0.1,
                         torch.rand(3))
    ops.gauss_sketch(v, 7, 0, 3)
    ops.svt_reconstruct(torch.randn(16, 3), torch.rand(3), torch.randn(3, 4))
    x, y = torch.randn(16, 4), torch.randn(16)
    block = ref.sample_scalars(16, 3, [9], [11])[0]
    ops.lstsq_grad_sampled(x, v[0], y, block, 3)
    blocks = torch.from_numpy(ref.sample_scalars(16, 3, [9, 4], [11, 16]))
    rows = ops.lstsq_grad_sampled_batch(
        torch.stack([x, x]), torch.stack([y, y]),
        torch.tensor([1, 0], dtype=torch.int32), v[:2].contiguous(), blocks, 3)
    assert rows.shape == (2, 4)
    assert ops.sample_mask(16, block, "cpu").sum() == 3
    ops.lstsq_grad(x, v[0], y, 11)
    ops.lstsq_grad(x, v[0], y)
    counts = torch.tensor([11, 16], dtype=torch.int32)
    ops.lstsq_grad_task(torch.stack([x, x]), torch.stack([y, y]), 1, v[0],
                        counts)
    rows = ops.lstsq_grad_batch(torch.stack([x, x]), torch.stack([y, y]),
                                torch.tensor([1, 0, 5], dtype=torch.int32),
                                v[:3].contiguous(), counts)
    assert rows.shape == (3, 4)
    assert ops.sample_rows(x, block).any(dim=1).sum() == 3
    q, kv = torch.randn(5, 4, 8), torch.randn(5, 2, 8)
    ops.flash_attention(q, kv, kv, causal=True, window=3, softcap=20.0)
    ops.mha(q[None], kv[None], kv[None], causal=False, kv_valid_len=4)
    r = torch.randn(1, 6, 2, 32)
    state = torch.zeros(1, 2, 32, 32)
    ops.wkv(r, r, r, torch.rand(1, 6, 2, 32), torch.randn(2, 32), state,
            chunk=4)
    assert bool(state.any())                 # written in place
    ops.rwkv6_scan(r[0], r[0], r[0], torch.rand(6, 2, 32), torch.randn(2, 32))
    ops.km_update(v, v, v, 0.1, 0.5)
    ops.km_update(v.bfloat16(), v.bfloat16(), v.bfloat16(), 0.1, 0.5)
    ops.l21_prox(v, 0.3)
    ops.l21_prox(v.bfloat16(), 0.3)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_kernel_wrappers_refuse_cpu_tensors():
    """Called directly, a kernel wrapper takes only CUDA tensors: there is
    no path from a kernel wrapper to the plain version."""
    v = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        k_event.amtl_event(v, v, v, 0.1, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        k_batch.amtl_event_batch(torch.zeros(8, 2), torch.zeros(8, 1),
                                 torch.zeros(8, 1),
                                 torch.zeros(1, dtype=torch.int32), 0.1,
                                 torch.zeros(1))
    with pytest.raises(ValueError, match="CUDA"):
        k_sketch.gauss_sketch(torch.zeros(8, 2), 1, 0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        k_recon.svt_reconstruct(torch.zeros(8, 2), torch.zeros(2),
                                torch.zeros(2, 3))
    x, y = torch.zeros(8, 2), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        k_sampled.lstsq_grad_sampled(x, torch.zeros(2), y, (1, 2, 3, 8), 2)
    with pytest.raises(ValueError, match="CUDA"):
        k_sampled.lstsq_grad_sampled_batch(
            x[None], y[None], torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, 2), torch.zeros((1, 4), dtype=torch.uint32), 2)
    with pytest.raises(ValueError, match="CUDA"):
        k_grad.lstsq_grad(x, torch.zeros(2), y, 4)
    with pytest.raises(ValueError, match="CUDA"):
        k_grad.lstsq_grad_task(x[None], y[None], 0, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        k_grad.lstsq_grad_batch(x[None], y[None],
                                torch.zeros(1, dtype=torch.int32),
                                torch.zeros(1, 2),
                                torch.full((1,), 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        k_mask.sample_mask(8, (1, 2, 3, 8), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        k_mask.sample_rows(x, (1, 2, 3, 8))
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        k_flash.flash_attention(q, q, q, causal=True)
    for route in k_flash.ROUTES:        # a forced route is no way round it
        with pytest.raises(ValueError, match="CUDA"):
            k_flash.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                                    causal=True, route=route)
    r = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        k_rwkv.wkv(r, r, r, r, torch.zeros(2, 32), torch.zeros(1, 2, 32, 32))
    r = torch.zeros(1, 4, 2, 64)
    for route in k_rwkv.ROUTES:         # a forced route is no way round it
        with pytest.raises(ValueError, match="CUDA"):
            k_rwkv.wkv(r.bfloat16(), r.bfloat16(), r.bfloat16(), r,
                       torch.zeros(2, 64), torch.zeros(1, 2, 64, 64),
                       route=route)
    with pytest.raises(ValueError, match="CUDA"):
        k_km.km_update(v, v, v, 0.1, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        k_l21.l21_prox(torch.zeros(8, 2), 0.3)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_kernel_library_is_named_by_its_sources():
    """The library's name follows a hash of the sources and flags, under
    build/ at the repository root (listed in .gitignore)."""
    path = _build.library_path()
    assert path.parent == SRC.parent / "build" / "repro_torch_kernels"
    assert {p.name for p in _build.sources()} == {
        "amtl_event.cu", "amtl_event_batch.cu", "gauss_sketch.cu",
        "svt_reconstruct.cu", "lstsq_grad.cu", "lstsq_grad_sampled.cu",
        "flash_attention.cu", "flash_attention_sm90.cu", "flash_decode.cu",
        "rwkv6_scan.cu", "rwkv6_chunked.cu", "km_update.cu", "l21_prox.cu"}
    assert {p.name for p in _build.headers()} == {
        "counter_hash.cuh", "km_column.cuh"}
    assert path.name.startswith("librepro_torch_kernels-")


def test_kernel_library_name_follows_the_shared_headers(tmp_path,
                                                        monkeypatch):
    """An edit to a shared header (`csrc/*.cuh`) names a new library, so a
    stale build is never reused."""
    for src in _build.sources() + _build.headers():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / "counter_hash.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One compiler process per source, then one link, with a stand-in
    compiler that records its arguments and writes its output file."""
    fake = tmp_path / "nvcc"
    log = tmp_path / "calls.log"
    fake.write_text(
        "#!" + sys.executable + "\n"
        "import sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    path, _ = _build.build()
    assert path.exists() and path.parent == tmp_path / "build"
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in c]
    assert len(compiles) == len(_build.sources())
    assert calls[-1].split().count("-shared") == 1
    assert "sm_90a" in calls[-1]
    assert not list((tmp_path / "build").glob("*.o"))
    assert _build.build() == (path, 0.0)         # reused, not rebuilt
