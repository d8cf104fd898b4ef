#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from `src/repro_torch/csrc/`, holds each
kernel against its plain PyTorch version on the card, drives the port's
main path — the AMTL engine session, batch engine with the randomized-SVT
prox and delta engine, at full width — holds the card's run against the
port's own CPU run of the same state, and times each kernel.  Any failed
phase exits non-zero.  The last three lines of standard output are the
kernel table as JSON, the card's name and power limit, and
`{"ok": true, "device": {...}}`.

Imports torch and the port only (never JAX or the reference package).
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores

# The `batch` row of the reference's engine bench, at full width: lstsq
# loss, nuclear norm, lam 0.1, d 8192, T 128, tau 8, eta 0.05, event_batch
# 32, prox_every 32, prox_rank 16; n = 256 rows a task (a hospital cohort
# of examples/hospitals_async.py runs 85-372 rows).
D, T, N_ROWS, TAU = 8192, 128, 256, 8
ETA, LAM, RANK, BATCH = 0.05, 0.1, 16, 32
BATCH_EVENTS, DELTA_EVENTS, DELTA_PROX_EVERY, CPU_EVENTS = 4096, 256, 8, 64

# Tolerances of the kernels against their plain versions on the card.  The
# two column-update kernels and their plain versions compute the same fma
# sequence, so they must agree bitwise.  The sketch's normals come from
# CUDA's logf/cosf/sqrtf against PyTorch's (an ulp apart) and both
# products sum in another order, so they agree to float32 rounding of a
# T-term (sketch) or p-term (reconstruction) sum, scaled by its size.
SKETCH_RTOL = 1e-5
RECON_RTOL = 1e-5
# The card's session against the port's CPU session over 64 events: same
# event stream bitwise; the iterate differs by the float32 rounding of the
# gradients' and the prox's matrix products (cuBLAS/cuSOLVER against the
# CPU's), carried through 64 events.
SESSION_RTOL = 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 21, inner: int = 10, warmup: int = 3,
            backlog: bool = True) -> float:
    """Median over `reps` windows of `inner` back-to-back calls, from CUDA
    events, in ms per call (after `warmup` calls).

    With `backlog`, each window starts behind a ~3 ms device sleep, so the
    host has queued all `inner` calls before the first runs: the window
    then measures the calls' device time, not the host's issue rate (a
    Python wrapper issues a launch in tens of microseconds, longer than
    these kernels run).  Without it the window is the calls' wall time on
    the stream, host included, as for plain versions that synchronize.
    """
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if backlog:
            torch.cuda._sleep(5_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 3 --

def check_kernels(dev, gen) -> dict:
    """Each kernel against its plain version on the card; returns the
    main-shape inputs and errors for the timing phase."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import amtl_event as k_event
    from repro_torch.kernels import amtl_event_batch as k_batch
    from repro_torch.kernels import gauss_sketch as k_sketch
    from repro_torch.kernels import svt_reconstruct as k_recon

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def same_bits(a, b) -> bool:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    info = {}
    # amtl_event: main width, a d that is not a multiple of the block, eta_k 0
    for d, eta_k in ((D, 0.37), (1000, 0.37), (D, 0.0)):
        v, p, g = randn(d), randn(d), randn(d)
        kv, kold = k_event.amtl_event(v, p, g, ETA, eta_k)
        rv, rold = ref.amtl_event_ref(v, p, g, ETA, eta_k)
        torch.cuda.synchronize()
        if not (same_bits(kv, rv) and same_bits(kold, rold)
                and same_bits(kold, v)):
            fail(f"amtl_event d={d} eta_k={eta_k}: not bitwise "
                 f"(max |diff| {(kv - rv).abs().max().item():.3g})")
        if d == D and eta_k:
            info["amtl_event"] = dict(args=(v, p, g, ETA, eta_k), err=0.0)
    log("amtl_event: bitwise against its plain version (d=8192, d=1000, "
        "eta_k=0)")

    # amtl_event_batch: main shape with the run's duplicates, forced
    # duplicates, a sentinel id T (dropped), eta_k 0, d=1000
    cases = []
    tasks = torch.randint(0, T, (BATCH,), generator=gen, device=dev,
                          dtype=torch.int32)
    cases.append(("main", D, tasks, None))
    dup = tasks.clone()
    dup[5] = dup[3] = dup[17] = dup[30]
    dup[9] = T
    dup[21] = T
    cases.append(("duplicates+sentinel", D, dup, 11))
    cases.append(("d=1000", 1000, tasks, None))
    for label, d, ts, zero_at in cases:
        v = randn(d, T)
        p, g = randn(d, BATCH), randn(d, BATCH)
        eks = torch.rand(BATCH, generator=gen, device=dev)
        if zero_at is not None:
            eks[zero_at] = 0.0
        kv, kundo = k_batch.amtl_event_batch(v.clone(), p, g, ts, ETA, eks)
        rv, rundo = ref.amtl_event_batch_ref(v.clone(), p, g, ts, ETA, eks)
        torch.cuda.synchronize()
        if not (same_bits(kv, rv) and same_bits(kundo, rundo)):
            fail(f"amtl_event_batch {label}: not bitwise "
                 f"(max |diff| v {(kv - rv).abs().max().item():.3g}, "
                 f"undo {(kundo - rundo).abs().max().item():.3g})")
        if label == "main":
            info["amtl_event_batch"] = dict(args=(v, p, g, ts, ETA, eks),
                                            err=0.0)
    log("amtl_event_batch: bitwise against its plain version (main shape, "
        "duplicates, sentinel id, eta_k=0, d=1000)")

    # gauss_sketch: main shape (p = rank + 8), ragged edge with an offset
    p_main = min(RANK + 8, min(D, T))
    for d, tt, p, off in ((D, T, p_main, 0), (1000, 100, 7, 5)):
        w = randn(d, tt)
        seed = int(torch.randint(0, 2**31, (1,), generator=gen,
                                 device=dev).item())
        k = k_sketch.gauss_sketch(w, seed, off, p)
        r = ref.gauss_sketch_ref(w, seed, off, p)
        scale = (w.abs() @ ref.gauss_omega_ref(tt, p, seed, off, dev).abs())
        err = (k - r).abs()
        if not bool((err <= SKETCH_RTOL * scale).all()):
            fail(f"gauss_sketch d={d} t={tt} p={p}: max |diff| "
                 f"{err.max().item():.3g} > {SKETCH_RTOL} * sum|w||omega|")
        if d == D:
            info["gauss_sketch"] = dict(args=(w, seed, 0, p),
                                        err=err.max().item())
    log(f"gauss_sketch: within {SKETCH_RTOL} x sum|w||omega| of its plain "
        f"version (d=8192 p={p_main}, d=1000 t=100 p=7 offset 5)")

    for d, p, m in ((D, p_main, T), (1000, 7, 100)):
        qu, vt = randn(d, p), randn(p, m)
        s = torch.rand(p, generator=gen, device=dev) * 3.0
        s[1] = 0.0
        k = k_recon.svt_reconstruct(qu, s, vt)
        r = ref.svt_reconstruct_ref(qu, s, vt)
        scale = (qu.abs() * s) @ vt.abs()
        err = (k - r).abs()
        if not bool((err <= RECON_RTOL * scale + 1e-30).all()):
            fail(f"svt_reconstruct d={d} p={p} m={m}: max |diff| "
                 f"{err.max().item():.3g} > {RECON_RTOL} * sum|qu s||vt|")
        if d == D:
            info["svt_reconstruct"] = dict(args=(qu, s, vt),
                                           err=err.max().item())
    log(f"svt_reconstruct: within {RECON_RTOL} x sum|qu s||vt| of its "
        f"plain version (d=8192 p={p_main} m=128, d=1000 p=7 m=100)")
    ops.reset_launch_counts()
    return info


# ------------------------------------------------------------- phases 4-6 --

def make_problem(seed: int, dev, d: int = D, t: int = T, n: int = N_ROWS):
    """Seeded lstsq/nuclear problem: Y = X W* + noise with a rank-4 W*."""
    import torch
    from repro_torch.core import MTLProblem
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn(t, n, d, generator=gen, device=dev) / d ** 0.5
    w_star = (torch.randn(d, 4, generator=gen, device=dev)
              @ torch.randn(4, t, generator=gen, device=dev))
    ys = (torch.bmm(xs, w_star.T.unsqueeze(2)).squeeze(2)
          + 0.01 * torch.randn(t, n, generator=gen, device=dev))
    v0 = 0.01 * torch.randn(d, t, generator=gen, device=dev)
    offs = torch.randint(0, TAU + 1, (t,), generator=gen, device=dev)
    return (MTLProblem(xs, ys, "lstsq", "nuclear", LAM), v0,
            offs.to(torch.float32).cpu().numpy())


def configs(t: int = T):
    from repro_torch.core import AMTLConfig
    from repro_torch.core.operators import amtl_max_step
    base = AMTLConfig(eta=ETA, eta_k=amtl_max_step(TAU, t, 0.9), tau=TAU,
                      prox_rank=RANK)
    return (base._replace(engine="batch", event_batch=BATCH,
                          prox_every=BATCH),
            base._replace(engine="delta", prox_every=DELTA_PROX_EVERY))


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_session(problem, cfg, v0, key, offs, num_events, dev) -> dict:
    """init -> run -> iterate through the public API, with the launch
    counts of exactly that run, and host/device times of a second,
    identical run split into its host plan and its device work."""
    from repro_torch.core import amtl, make_engine
    from repro_torch.kernels import ops
    engine = make_engine(problem, cfg, device=dev)
    state0 = engine.init(v0, key)
    engine.run(state0, offs, engine.events_per_step * 2)      # warm up
    sync(dev)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = engine.run(state0, offs, num_events)
    v = engine.iterate(state)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    t0 = time.perf_counter()
    plan = amtl.plan_events(problem, cfg, state0, offs, num_events)
    host = time.perf_counter() - t0
    t0 = time.perf_counter()
    amtl.apply_plan(problem, cfg, state0, plan)
    sync(dev)
    device_side = time.perf_counter() - t0
    return dict(state=state, v=v, counts=counts, wall=wall, host=host,
                device=device_side)


def device_profile(problem, cfg, v0, key, offs, num_events, dev) -> tuple:
    """(busy seconds, top kernels) of the device work of one run, from
    torch.profiler's CUDA activity: the sum of kernel and copy times on
    the card while `apply_plan` runs (the host plan is made beforehand)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import amtl, make_engine
    state0 = make_engine(problem, cfg, device=dev).init(v0, key)
    plan = amtl.plan_events(problem, cfg, state0, offs, num_events)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        amtl.apply_plan(problem, cfg, state0, plan)
        sync(dev)
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return sum(t for _, t in rows) * 1e-6, rows[:8]


def objective(problem, cfg, v) -> float:
    from repro_torch.core.operators import backward
    return float(problem.objective(backward(problem, v, cfg.eta)))


def compare_states(label: str, card, cpu) -> float:
    """Host fields bitwise, tensors to SESSION_RTOL of their scale."""
    import numpy as np
    for f in ("task_ring", "key"):
        if not np.array_equal(getattr(card, f), getattr(cpu, f)):
            fail(f"{label}: {f} differs between the card and the CPU")
    if (card.ptr, card.event) != (cpu.ptr, cpu.event):
        fail(f"{label}: ptr/event differ between the card and the CPU")
    if not (np.array_equal(card.history.buf, cpu.history.buf)
            and np.array_equal(card.history.count, cpu.history.count)):
        fail(f"{label}: delay history differs between the card and the CPU")
    worst = 0.0
    for f in ("v", "delta_ring"):
        a = getattr(card, f).cpu().double()
        b = getattr(cpu, f).double()
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
        if not rel <= SESSION_RTOL:
            fail(f"{label}: {f} max |card - cpu| / max|cpu| = {rel:.3g} > "
                 f"{SESSION_RTOL}")
    return worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    try:
        from repro_torch.core import prng
        from repro_torch.kernels import _build, ops, ref
    except ImportError as e:
        fail(f"the port (src/repro_torch) is not next to chip_smoke.py: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())

    # phase 1: device
    card = card_line()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(card)

    # phase 2: build
    path, secs = _build.build(verbose=True)
    _build.load()
    log(f"phase 2 build: {path.name} in {secs:.1f} s")

    # phase 3: kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    info = check_kernels(dev, gen)
    log("phase 3 kernels: PASS")

    # phase 4: batch-engine session at full width
    problem, v0, offs = make_problem(args.seed, dev)
    key = prng.key_from_seed(args.seed)
    batch_cfg, delta_cfg = configs()
    obj0 = objective(problem, batch_cfg, v0)
    b = run_session(problem, batch_cfg, v0, key, offs, BATCH_EVENTS, dev)
    if tuple(b["v"].shape) != (D, T) or not bool(torch.isfinite(b["v"]).all()):
        fail("batch session: iterate not finite or of the wrong shape")
    need = BATCH_EVENTS // BATCH
    for k in ("amtl_event_batch", "gauss_sketch", "svt_reconstruct"):
        if b["counts"][k] < need:
            fail(f"batch session: {k} launched {b['counts'][k]} < {need} "
                 "times")
    obj1 = objective(problem, batch_cfg, b["v"])
    if not obj1 < obj0:
        fail(f"batch session: objective did not fall ({obj0} -> {obj1})")
    log(f"phase 4 batch session: {BATCH_EVENTS} events, launches "
        f"{b['counts']}, objective {obj0:.6g} -> {obj1:.6g}: PASS")

    # phase 5: delta-engine session
    dl = run_session(problem, delta_cfg, v0, key, offs, DELTA_EVENTS, dev)
    if not bool(torch.isfinite(dl["v"]).all()):
        fail("delta session: iterate not finite")
    if dl["counts"]["amtl_event"] != DELTA_EVENTS:
        fail(f"delta session: amtl_event launched "
             f"{dl['counts']['amtl_event']} != {DELTA_EVENTS} times")
    refreshes = DELTA_EVENTS // DELTA_PROX_EVERY
    for k in ("gauss_sketch", "svt_reconstruct"):
        if dl["counts"][k] < refreshes:
            fail(f"delta session: {k} launched {dl['counts'][k]} < "
                 f"{refreshes} times")
    log(f"phase 5 delta session: {DELTA_EVENTS} events, launches "
        f"{dl['counts']}: PASS")

    # phase 6: the card against the port's own CPU run of the same state
    cpu = torch.device("cpu")
    problem_cpu = problem._replace(xs=problem.xs.cpu(), ys=problem.ys.cpu())
    worst = {}
    for label, cfg in (("batch", batch_cfg), ("delta", delta_cfg)):
        card_s = run_session(problem, cfg, v0, key, offs, CPU_EVENTS,
                             dev)["state"]
        cpu_s = run_session(problem_cpu, cfg, v0.cpu(), key, offs,
                            CPU_EVENTS, cpu)["state"]
        worst[label] = compare_states(label, card_s, cpu_s)
    log(f"phase 6 card vs CPU ({CPU_EVENTS} events): event streams bitwise, "
        f"max relative |diff| of v/delta_ring {worst} <= {SESSION_RTOL}: "
        "PASS")

    # phase 7: times
    for label, r, n in (("batch", b, BATCH_EVENTS), ("delta", dl,
                                                      DELTA_EVENTS)):
        log(f"phase 7 {label} engine: {n / r['wall']:.1f} events/s end to "
            f"end ({r['wall']:.3f} s); host plan {r['host']:.3f} s "
            f"({n / r['host']:.1f} events/s), device work "
            f"{r['device']:.3f} s ({n / r['device']:.1f} events/s)")
    for label, cfg, n, r in (("batch", batch_cfg, BATCH_EVENTS, b),
                             ("delta", delta_cfg, DELTA_EVENTS, dl)):
        try:
            busy, top = device_profile(problem, cfg, v0, key, offs, n, dev)
        except RuntimeError as e:       # no CUPTI tracing on this machine
            log(f"phase 7 {label} engine device busy share: not measured "
                f"({e})")
            continue
        log(f"phase 7 {label} engine device busy {busy:.4f} s of the "
            f"{r['device']:.3f} s device-work window "
            f"({100 * busy / r['device']:.1f}%), torch.profiler; top: "
            + "; ".join(f"{k[:60]} {t / 1e3:.1f} ms" for k, t in top))
    kernels = []
    per_batch = {"amtl_event": BATCH, "amtl_event_batch": 1,
                 "gauss_sketch": 1, "svt_reconstruct": 1}
    launches = {k: (dl if k == "amtl_event" else b)["counts"][k]
                for k in per_batch}
    for name in ("amtl_event_batch", "gauss_sketch", "svt_reconstruct",
                 "amtl_event"):
        args_ = info[name]["args"]
        kern = ops.KERNELS[name]
        if name == "amtl_event":
            v, p, g, eta, eta_k = args_
            d = v.shape[0]
            nbytes, flops = 5 * 4 * d, 4 * d
            kfn = lambda: kern.amtl_event(v, p, g, eta, eta_k)
            pfn = lambda: ref.amtl_event_ref(v, p, g, eta, eta_k)
            lib = None
            src, rep = "amtl_event.cu", "src/repro/kernels/amtl_event.py:69"
        elif name == "amtl_event_batch":
            v, p, g, ts, eta, eks = args_
            d, bsz = p.shape
            uniq = int(torch.unique(ts[ts < T]).numel())
            nbytes = 4 * (2 * d * uniq + 2 * d * bsz + d * bsz + 2 * bsz)
            flops = 4 * d * bsz
            vk, vr = v.clone(), v.clone()
            kfn = lambda: kern.amtl_event_batch(vk, p, g, ts, eta, eks)
            pfn = lambda: ref.amtl_event_batch_ref(vr, p, g, ts, eta, eks)
            lib = None
            src = "amtl_event_batch.cu"
            rep = "src/repro/kernels/amtl_event_batch.py:138"
        elif name == "gauss_sketch":
            w, seed, off, p = args_
            d, tt = w.shape
            nbytes, flops = 4 * (d * tt + d * p), 2 * d * tt * p
            omega = ref.gauss_omega_ref(tt, p, seed, off, dev)
            kfn = lambda: kern.gauss_sketch(w, seed, off, p)
            pfn = lambda: ref.gauss_sketch_ref(w, seed, off, p)
            lib = lambda: torch.matmul(w, omega)
            src, rep = "gauss_sketch.cu", "src/repro/kernels/gauss_sketch.py:83"
        else:
            qu, s, vt = args_
            d, p = qu.shape
            m = vt.shape[1]
            nbytes = 4 * (d * p + p + p * m + d * m)
            flops = 2 * d * p * m + d * p
            kfn = lambda: kern.svt_reconstruct(qu, s, vt)
            pfn = lambda: ref.svt_reconstruct_ref(qu, s, vt)
            lib = lambda: (qu * s) @ vt
            src = "svt_reconstruct.cu"
            rep = "src/repro/kernels/svt_reconstruct.py:72"
        saved = kern.launches
        k_ms = cuda_ms(kfn)
        issue_ms = cuda_ms(kfn, backlog=False)
        p_ms = cuda_ms(pfn, inner=1, backlog=False)
        l_ms = cuda_ms(lib) if lib is not None else None
        kern.launches = saved           # timing launches are not the path's
        bnd, by = bound_ms(nbytes, flops)
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=rep, launches=launches[name],
            max_abs_err=info[name]["err"], ms=k_ms, plain_ms=p_ms,
            bound_ms=bnd, bound_by=by, library_ms=l_ms))
        log(f"phase 7 {name}: {k_ms * 1e3:.2f} us on the device (bound "
            f"{bnd * 1e3:.2f} us by {by}; {issue_ms * 1e3:.2f} us a call "
            f"when the host issues them one by one), plain "
            f"{p_ms * 1e3:.1f} us, library "
            f"{'n/a' if l_ms is None else f'{l_ms * 1e3:.2f} us'}, "
            f"{per_batch[name]} launch(es) per {BATCH}-event batch, "
            f"{launches[name]} on the main path")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
