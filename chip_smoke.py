#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from `src/repro_torch/csrc/`, holds each
kernel against its plain PyTorch version on the card (the delta and dense
engines' in-place state updates too), drives the port's
main paths at full width — the AMTL engine session (batch engine with the
randomized-SVT prox, delta engine), SGD-AMTL on ragged task cohorts
published by a TaskStore (batch, delta and logistic sessions, a store
append between two chunks), gemma2-2b serving (prefill and greedy
decode through `repro_torch.launch.serve`, every bf16 prefill attention
call in the tensor-core flash kernel and every decode call in the split-KV
kernel) and rwkv6-3b serving (every bf16 prefill WKV in the chunked
tensor-core kernel and every decode WKV in the recurrent one), the dense
engine and the l2,1 (joint feature learning) formulation (dense sessions
with the km_update and l21_prox kernels, dense == delta bitwise, a batch
l2,1 session, FISTA's reference optimum) and the learn-while-serve
`AMTLServer` on the ragged store (cooperative serving with a checkpoint
and a bitwise resume, threaded learning, chaos under a FaultPlan), and
the task-sharded engine (one rank in process, then two ranks sharing
the card in a gloo world: both proxes, a straggler shard, a checkpoint
restored into a fresh world, SGD on the ragged store) — holds
the card's runs against the port's own CPU runs, replays or plain-kernel
runs of the same states, and times
each kernel (the prox's two kernels and the engines' state updates
L2-cold too, and one prox refresh by part, with the calls that
synchronize the host).  Any failed
phase exits non-zero.  The last three lines of standard output are the
kernel table as JSON, the card's name and power limit, and
`{"ok": true, "device": {...}}`.

Imports torch and the port only (never JAX or the reference package).
Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 dense tensor cores
TF32_FLOP_PER_S = 495e12       # H100 SXM TF32 dense tensor cores

# The `batch` row of the reference's engine bench, at full width: lstsq
# loss, nuclear norm, lam 0.1, d 8192, T 128, tau 8, eta 0.05, event_batch
# 32, prox_every 32, prox_rank 16; n = 256 rows a task (a hospital cohort
# of examples/hospitals_async.py runs 85-372 rows).
D, T, N_ROWS, TAU = 8192, 128, 256, 8
ETA, LAM, RANK, BATCH = 0.05, 0.1, 16, 32
BATCH_EVENTS, DELTA_EVENTS, DELTA_PROX_EVERY, CPU_EVENTS = 4096, 256, 8, 64

# SGD-AMTL on ragged cohorts (examples/hospitals_async.py): T 128 cohorts
# of rng.integers(80, 400) rows drawn from --seed, padded to the largest
# by a TaskStore, minibatch 32, dynamic step; 256 labelled rows appended
# between the two chunks of the batch session.
COHORT_LO, COHORT_HI, SGD_BATCH, APPEND_ROWS = 80, 400, 32, 256
LOGISTIC_EVENTS = 64

# The learn-while-serve server (repro_torch.serve, phase 20) on the ragged
# store above (make_store) and the uniform cell's batch engine (full
# gradient, randomized SVT): 64 request batches, each 64 prediction rows and
# 64 labelled feedback rows (task ids uniform), 4096 events in all; the
# resume after batch 31 (the checkpoint at 2048 events).  The chaos drive
# serves the first SERVE_CHAOS_BATCHES batches.  Checkpoints go under
# build/serve_ckpt (a store record is 1.7-3.3 GB; the phase needs
# SERVE_FREE_BYTES free there and deletes the directory at its end).
SERVE_BATCHES, SERVE_ROWS, SERVE_RESUME_AT, SERVE_CHAOS_BATCHES = 64, 64, 32, 7
SERVE_CFG = dict(chunk_events=128, task_chunk_quota=8, max_pending_per_task=64,
                 max_batch=256, slo_ms=250.0, slo_window=32, keep_last=2,
                 checkpoint_every=2048)
SERVE_FREE_BYTES = 24e9
SERVE_WAIT_S = 300.0

# The task-sharded engine (phase 21) at the batch cell's configuration
# (the cell above): one rank in this process, then SHARD_RANKS ranks in a
# torch.distributed world on this one card (gloo: NCCL refuses two ranks
# on one device; gloo copies the collectives through host memory).  The
# distributed prox's iterate is held to the batch engine's within
# SHARD_RTOL of its scale after SHARD_GATE_EVENTS events (its (d, p) sum
# regroups the sketch's sum over T: float32 rounding carried through the
# QR, the SVD and 2 refreshes); the replicated prox is bitwise.  The
# checkpoint part writes under build/shard_ckpt (deleted after).
SHARD_RANKS, SHARD_GATE_EVENTS, SHARD_RTOL = 2, 64, 1e-3
SHARD_WORLD_TIMEOUT_S, SHARD_COLLECTIVE_TIMEOUT_S = 600.0, 120.0

# Tolerances of the kernels against their plain versions on the card.  The
# two column-update kernels and their plain versions compute the same fma
# sequence, so they must agree bitwise.  The sketch's normals come from
# CUDA's logf/cosf/sqrtf against PyTorch's (an ulp apart) and both
# products sum in another order, so they agree to float32 rounding of a
# T-term (sketch) or p-term (reconstruction) sum, scaled by its size.
SKETCH_RTOL = 1e-5
RECON_RTOL = 1e-5
# The two gradient kernels against their plain versions: one rounding per
# term of the kept rows' sums, in another order than PyTorch's matmuls,
# bounded by 1e-5 of scale2 |X_K|^T |r_K| (K the kept rows).
GRAD_RTOL = 1e-5
# The card's session against the port's CPU session over 64 events: same
# event stream bitwise; the iterate differs by the float32 rounding of the
# gradients' and the prox's matrix products (cuBLAS/cuSOLVER against the
# CPU's), carried through 64 events.
SESSION_RTOL = 1e-3

# gemma2-2b serving at its published width (configs/gemma2_2b.py: 26
# layers, d_model 2304, 8 query and 4 kv heads of 256, window 4096,
# softcaps 50 and 30, vocab 256000, bfloat16, 2614M parameters), random
# weights from --seed.  Batch 2, a prompt of 5000 tokens (it crosses the
# 4096 window and is a multiple of neither the window nor the kernel's
# 64-query tile), 32 greedy decode steps.
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 5000, 32
# The flash kernel against its plain version: float32 sums in another
# order (2e-5); in bfloat16 both round the float32 result once, so they
# differ by at most one bf16 ulp of the output (2e-2 at |o| < 2).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The same, relative to each output row (a (batch, query, head) row: its
# max |diff| over hd over its max |o|), on the rows that keep a key.  With
# randn inputs a row of N kept keys has |o| ~ sqrt(e / N), 0.02 at N 5000,
# so FLASH_TOL alone would not see a 64-key tile left out or a window edge
# off by a tile, which move such a row by about its own size.  `sm90` is
# held against the plain version in its own order and rounding (64-key
# chunks, P rounded to bf16 for the tensor cores), the other routes
# against `mha_ref`.  On an H100 the sound readings were at most 0.0078
# in bf16 (a one-ulp flip of the output's rounding at the row's max,
# 2^-7) and 5.9e-6 in float32, so the limits are 2^-6 and 2e-5; the
# controls, which must fail, read 0.14 (a 64-key tile left out of the
# 4096-slot ring) to 0.95 (the local prefill's window a tile wide).
FLASH_ROW_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -6}
SM90_CHUNK = 64            # csrc/flash_attention_sm90.cu's BK: its sum order
# The served logits through the kernel against the plain run, relative to
# max |logits|: bf16 rounding differences carried through 26 layers; and
# in float32 (TF32 off), where bf16 noise cannot hide a kernel error.
SERVE_RTOL = 3e-2
SERVE_F32_RTOL = 1e-4
# Where two plain versions of an arch's kernel exist (rwkv6-3b: the
# sequential and the chunked WKV), the bf16 gate is also measured: the
# sequential run's distance from the chunked run is the bf16 noise of the
# served model (0.045 of max|logits| over 32 layers on an H100), and the
# kernel's run must come within NOISE_FACTOR of it, or within SERVE_RTOL,
# whichever is larger.
NOISE_FACTOR = 1.5

# rwkv6-3b serving at its published width (configs/rwkv6_3b.py: 32 layers,
# d_model 2560, 40 heads of 64, d_ff 8960, vocab 65536, bfloat16, untied
# unembedding), random weights from --seed, at gemma2's serve shapes (the
# 5000-token prompt is not a multiple of the plain version's 128-token
# chunk, so its padding runs).  The WKV kernel against its plain versions:
# against the chunked form (exp/log of cumulative decays against repeated
# products) the float32 output to 1e-5 of its scale and the state to 1e-5
# of its scale, the bf16 output to 1e-2 of its scale (one bf16 rounding of
# each, 2^-8 relative); against the sequential `wkv_ref`, which rounds the
# state update as the kernel does, the state bit for bit and the output as
# above (another order of sums).
WKV_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
WKV_STATE_RTOL = 1e-5
WKV_CHUNK = 128
# The chunked WKV route (csrc/rwkv6_chunked.cu, bf16 r, k, v and out)
# against its own plain version (`ref.wkv_subchunk_ref`: its factorisation
# and its rounding) and against the exact recurrence (`ref.wkv_ref`), by
# output row (a (b, t, h) row of D: its max |diff| over its max |out|,
# the plain versions' float32 output as the yardstick) and by state (max
# |diff| over max |state|).  Against its own plain version the kernel's
# output differs by its bf16 rounding (at most 2^-8 of a row's max,
# 3.9e-3) and float32 sums in another order, the state by the order of the
# tensor cores' float32 sums (~1e-6 over 313 steps at the served decays):
# limits 4e-3 and 1e-4.  Against the exact recurrence the TF32 operands add
# ~2^-11 of each product, about 3.4e-4 of the output's scale and 3.2e-4 of
# the state's over 400 tokens (tests/test_torch_rwkv6_chunked.py): limits
# 8e-3 (twice the bf16 rounding) and 1e-3.  (With S rounded once to TF32
# the kernel read 9.0e-3 of a row at w near 1e-6 on an H100, rows whose
# r . k cancels; it now takes S as a TF32 hi and a bf16 lo term, and the
# plain version does too.)  Controls, which must exceed a limit against
# each yardstick: the state dropped at one sub-chunk boundary, the decays
# read one token late, the bonus left out.
WKV_CHUNKED_ROW_TOL = {"plain": 4e-3, "exact": 8e-3}
WKV_CHUNKED_STATE_TOL = {"plain": 1e-4, "exact": 1e-3}

# The l2,1 (joint feature learning) formulation at the engine cells' width
# (lstsq, d 8192, T 128, n 256, tau 8, eta 0.05, lam 0.1: threshold
# eta*lam), and the dense engine of the reference's engine bench (its
# `dense` row: the nuclear norm with an exact SVD each event).  Dense
# sessions of 256 events (l2,1) and 64 (nuclear), the delta engine at
# prox_every 1 over the same 256 events, a batch l2,1 session of 4096
# events (event_batch 32, prox_every 32), and FISTA from zero.
DENSE_L21_EVENTS, DENSE_NUCLEAR_EVENTS = 256, 64
FISTA_ITERS, FISTA_CPU_ITERS = 300, 10
# The l2,1 kernel against its plain version: float32 within L21_RTOL of
# max|w| (a row's squares summed in another order); bf16 within one bf16
# ulp of the output (both round a float32 result once).  The KM update
# kernel writes the plain version's two fmas: bitwise, float32 and bf16.
L21_RTOL = 1e-6
# FISTA's objectives on the card against the port's CPU run: float32
# matrix products summed in another order, over 10 iterations.
FISTA_RTOL = 1e-5


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


def bound_ms(nbytes: float, flops: float,
             flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 3 --

def check_kernels(dev, gen) -> dict:
    """Each kernel against its plain version on the card; returns the
    main-shape inputs and errors for the timing phase."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import amtl_event as k_event

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
            info["amtl_event contiguous"] = dict(args=(v, p, g, ETA, eta_k),
                                                 err=0.0)
    log("amtl_event: bitwise against its plain version (d=8192, d=1000, "
        "eta_k=0)")

    info.update(check_engine_forms(dev, gen))
    info.update(check_event_batch(dev, gen))
    info.update(check_sketch_recon(dev, gen))
    info.update(check_sgd_kernels(dev, gen))
    info["lstsq_grad"] = check_lstsq_grad(dev, gen)
    check_shard_shapes(dev, gen)
    info.update(check_l21_km_kernels(dev, gen))
    info.update(check_flash_kernel(dev, gen))
    info.update(check_rwkv_kernel(dev, gen))
    ops.reset_launch_counts()
    return info


def check_engine_forms(dev, gen) -> dict:
    """The engines' one-launch state updates against their plain versions
    on the card, bitwise and in place: `amtl_event_inplace` on V (8192,
    128) with a depth-9 undo ring, `km_update_slot` on a (9, 8192, 128)
    dense ring, each at the main shapes and at the edges (the first and
    last column, T odd, d not a multiple of 4, a ring of one slot, eta_k
    0; for the slot update also the word path of a ring 4 bytes off
    16-byte alignment and a tail of vectors).  Every other column and slot
    must keep its bits, and a bad index must raise with no launch
    counted.  Returns the main shapes' arguments for the timing phase."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import amtl_event as k_event
    from repro_torch.kernels import km_update as k_km

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    info = {}
    depth = TAU + 1
    # (d, T, depth, t, slot, eta_k); the first is the main shape
    for d, tt, dp, t, slot, eta_k in (
            (D, T, depth, 37, 5, 0.37), (D, T, depth, 0, 8, 0.37),
            (D, T, depth, T - 1, 0, 0.37), (1000, 5, 4, 4, 3, 0.37),
            (D, T, 1, 5, 0, 0.37), (D, T, depth, 3, 2, 0.0)):
        v, ring, p, g = randn(d, tt), randn(dp, d), randn(d), randn(d)
        kv, kr, rv, rr = v.clone(), ring.clone(), v.clone(), ring.clone()
        k_event.amtl_event_inplace(kv, t, p, g, ETA, eta_k, kr, slot)
        ref.amtl_event_inplace_ref(rv, t, p, g, ETA, eta_k, rr, slot)
        torch.cuda.synchronize()
        others = torch.arange(tt, device=dev) != t
        rest = torch.arange(dp, device=dev) != slot
        if not (torch.equal(bits(kv), bits(rv)) and torch.equal(bits(kr),
                                                               bits(rr))
                and torch.equal(bits(kv[:, others]), bits(v[:, others]))
                and torch.equal(bits(kr[slot]), bits(v[:, t]))
                and torch.equal(bits(kr[rest]), bits(ring[rest]))):
            fail(f"amtl_event_inplace d={d} T={tt} depth={dp} t={t} "
                 f"slot={slot} eta_k={eta_k}: not bitwise its plain version, "
                 "or another column or slot changed (max |diff| "
                 f"{(kv - rv).abs().max().item():.3g})")
        if not info:
            info["amtl_event"] = dict(args=(v, t, p, g, ETA, eta_k, ring,
                                            slot), err=0.0)
    log("amtl_event_inplace: bitwise against its plain version in place "
        "(V 8192x128 with a depth-9 undo ring; t 0 and T-1; 1000x5; depth "
        "1; eta_k 0), other columns and slots untouched")

    # (depth, d, T, src, dst, t, eta_k, words of offset); the first is main
    for dp, d, tt, src, dst, t, eta_k, off in (
            (depth, D, T, 3, 4, 37, 0.37, 0), (depth, D, T, 8, 0, 0, 0.37, 0),
            (depth, D, T, 0, 1, T - 1, 0.37, 0),
            (4, 1000, 5, 1, 2, 4, 0.37, 0), (3, 1000, 6, 0, 1, 5, 0.37, 0),
            (3, 1001, 12, 2, 0, 11, 0.37, 0), (1, D, T, 0, 0, 5, 0.37, 0),
            (depth, D, T, 2, 3, 10, 0.0, 0), (depth, 300, T, 5, 6, 64, 0.37, 1)):
        flat = randn(dp * d * tt + off)
        ring = flat[off:].view(dp, d, tt)
        p, g = randn(d), randn(d)
        kr, rr = ring.clone(), ring.clone()
        if off:                        # keep the kernel's copy misaligned
            kflat = flat.clone()
            kr = kflat[off:].view(dp, d, tt)
        k_km.km_update_slot(kr, src, dst, t, p, g, ETA, eta_k)
        ref.km_update_slot_ref(rr, src, dst, t, p, g, ETA, eta_k)
        torch.cuda.synchronize()
        others = torch.arange(tt, device=dev) != t
        rest = torch.arange(dp, device=dev) != dst
        if not (torch.equal(bits(kr), bits(rr))
                and torch.equal(bits(kr[dst][:, others]),
                                bits(ring[src][:, others]))
                and torch.equal(bits(kr[rest]), bits(ring[rest]))):
            fail(f"km_update_slot depth={dp} d={d} T={tt} src={src} dst={dst}"
                 f" t={t} eta_k={eta_k} offset={off}: not bitwise its plain "
                 "version, or another column or slot changed (max |diff| "
                 f"{(kr - rr).abs().max().item():.3g})")
        if "km_update" not in info:
            info["km_update"] = dict(args=(ring, src, dst, t, p, g, ETA,
                                           eta_k), err=0.0)
    log("km_update_slot: bitwise against its plain version in place "
        "((9, 8192, 128) ring; dst 0 and t 0, t T-1, T 5 and 6 (words), "
        "1001x12 (a tail of vectors), depth 1 (the column in place), eta_k "
        "0, a ring 4 bytes off 16-byte alignment (words)), other columns "
        "and slots untouched")

    v, t, p, g, eta, eta_k, ring, slot = info["amtl_event"]["args"]
    dense = info["km_update"]["args"][0]
    before = ops.launch_counts()
    for bad in (lambda: k_event.amtl_event_inplace(v, T, p, g, eta, eta_k,
                                                   ring, slot),
                lambda: k_event.amtl_event_inplace(v, t, p, g, eta, eta_k,
                                                   ring, depth),
                lambda: k_event.amtl_event_inplace(v.double(), t, p, g, eta,
                                                   eta_k, ring, slot),
                lambda: k_km.km_update_slot(dense, 0, depth, t, p, g, eta,
                                            eta_k),
                lambda: k_km.km_update_slot(dense, -1, 0, t, p, g, eta,
                                            eta_k),
                lambda: k_km.km_update_slot(dense, 0, 1, T, p, g, eta,
                                            eta_k)):
        try:
            bad()
        except ValueError:
            continue
        fail("an engine form took an index outside its range or a float64 "
             "iterate")
    if ops.launch_counts() != before:
        fail("a refused engine-form call counted a launch")
    log("engine forms: t = T, slot = depth, src -1, a float64 iterate "
        "raise ValueError on the card with no launch counted")
    return info


def check_event_batch(dev, gen) -> dict:
    """amtl_event_batch against its plain version on the card, bitwise,
    in both write-back modes; returns the main shape's inputs."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import amtl_event_batch as k_batch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def same_bits(a, b) -> bool:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    info = {}
    # amtl_event_batch: main shape with the run's duplicates, forced duplicates, a sentinel id T (dropped), eta_k 0,
    # d=1000, d below a block's 32 rows, all 32 events on one task, all 32
    # sentinels (T and T+1, chained)
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
    cases.append(("d=20", 20, dup, None))
    cases.append(("one task", D, torch.full_like(tasks, T - 1), None))
    cases.append(("all sentinels", D, T + (torch.arange(
        BATCH, device=dev, dtype=torch.int32) % 2), None))
    for label, d, ts, zero_at in cases:
        v = randn(d, T)
        p, g = randn(d, BATCH), randn(d, BATCH)
        eks = torch.rand(BATCH, generator=gen, device=dev)
        if zero_at is not None:
            eks[zero_at] = 0.0
        rv, rundo = ref.amtl_event_batch_ref(v.clone(), p, g, ts, ETA, eks)
        kv, kundo = k_batch.amtl_event_batch(v.clone(), p, g, ts, ETA, eks)
        torch.cuda.synchronize()
        if not (same_bits(kv, rv) and same_bits(kundo, rundo)):
            fail(f"amtl_event_batch {label}: not bitwise "
                 f"(max |diff| v {(kv - rv).abs().max().item():.3g}, "
                 f"undo {(kundo - rundo).abs().max().item():.3g})")
        if label == "main":
            info["amtl_event_batch"] = dict(args=(v, p, g, ts, ETA, eks),
                                            err=0.0)
    log("amtl_event_batch: bitwise against its plain version (main shape, "
        "duplicates, sentinel id, eta_k=0, d=1000, d=20, one task, all "
        "sentinels)")

    return info


# The sketch's and the reconstruction's edge shapes: every (d, t, p) and
# (d, p, m) of these, besides the main shape.  A p past 256 and an m past
# one block's columns take the kernels' chunked paths.
EDGE_D, EDGE_T, EDGE_P = (1, 1000, 8193), (1, 100, 300, 4096), (1, 7, 257)


def wrap_offset(t: int, p: int) -> int:
    """A row_offset whose counters (row_offset + r) * p + c cross 2^32
    inside the t rows."""
    return 2**32 // p - t // 2


def check_sketch_recon(dev, gen) -> dict:
    """gauss_sketch and svt_reconstruct against their plain versions at the
    main shape and every edge shape, and two launches bitwise equal."""
    import itertools
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import gauss_sketch as k_sketch
    from repro_torch.kernels import svt_reconstruct as k_recon

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def same_bits(a, b) -> bool:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    info = {}
    sms = _build.sm_count(dev)
    p_main = min(RANK + 8, min(D, T))
    # (d, t, p, row_offset, W 4 bytes past a 16-byte boundary): the main
    # shape; two that reach the plan's other instances, 3 rows a lane and 6
    # rows a lane over 16 chunks of T; T % 4 != 0 over two and 33 chunks
    # (W by 4-byte copies); and a misaligned W (4-byte copies at T % 4 ==
    # 0), at the main shape and past one chunk of T and of p
    cases = [(D, T, p_main, 0, False), (D, T, 13, 5, False),
             (8193, 4096, p_main, wrap_offset(4096, p_main), False),
             (1000, 130, p_main, 5, False),
             (8193, 4097, 7, wrap_offset(4097, 7), False),
             (D, T, p_main, 5, True), (1000, 300, 257, 5, True)]
    for i, (d, tt, p) in enumerate(itertools.product(EDGE_D, EDGE_T,
                                                     EDGE_P)):
        wraps = tt * p > 1 and i % 2 == 0
        cases.append((d, tt, p, wrap_offset(tt, p) if wraps else 5, False))
    for d, tt, p, off, shifted in cases:
        if shifted:
            w = randn(d * tt + 1)[1:].view(d, tt)
            if w.data_ptr() % 16 == 0:
                fail("gauss_sketch: the shifted W is 16-byte aligned")
        else:
            w = randn(d, tt)
        seed = int(torch.randint(0, 2**31, (1,), generator=gen,
                                 device=dev).item())
        k = k_sketch.gauss_sketch(w, seed, off, p)
        again = k_sketch.gauss_sketch(w, seed, off, p)
        r = ref.gauss_sketch_ref(w, seed, off, p)
        scale = (w.abs() @ ref.gauss_omega_ref(tt, p, seed, off, dev).abs())
        err = (k - r).abs()
        if not bool((err <= SKETCH_RTOL * scale).all()):
            fail(f"gauss_sketch d={d} t={tt} p={p} row_offset {off} "
                 f"shifted {shifted}: max |diff| {err.max().item():.3g} > "
                 f"{SKETCH_RTOL} * sum|w||omega|")
        if not same_bits(k, again):
            fail(f"gauss_sketch d={d} t={tt} p={p} shifted {shifted}: two "
                 "launches differ")
        if (d, tt, p, off, shifted) == (D, T, p_main, 0, False):
            info["gauss_sketch"] = dict(args=(w, seed, 0, p),
                                        err=err.max().item())
    log(f"gauss_sketch: within {SKETCH_RTOL} x sum|w||omega| of its plain "
        f"version and two launches bitwise equal at d=8192 t=128 p={p_main} "
        f"(plan {k_sketch.plan(D, T, p_main, sms)}), d=8192 t=128 p=13, "
        f"d=8193 t=4096 p={p_main}, d=1000 t=130 p={p_main}, d=8193 t=4097 "
        f"p=7, W 4 bytes off 16-byte alignment at d=8192 t=128 p={p_main} "
        f"and d=1000 t=300 p=257, and every d in {EDGE_D}, t in {EDGE_T}, "
        f"p in {EDGE_P} (row_offset 5, or one whose counters wrap past "
        "2^32)")

    cases = [(D, p_main, T)] + list(itertools.product(EDGE_D, EDGE_P, EDGE_T))
    for d, p, m in cases:
        qu, vt = randn(d, p), randn(p, m)
        s = torch.rand(p, generator=gen, device=dev) * 3.0
        s[min(1, p - 1)] = 0.0
        k = k_recon.svt_reconstruct(qu, s, vt)
        again = k_recon.svt_reconstruct(qu, s, vt)
        r = ref.svt_reconstruct_ref(qu, s, vt)
        scale = (qu.abs() * s) @ vt.abs()
        err = (k - r).abs()
        if not bool((err <= RECON_RTOL * scale + 1e-30).all()):
            fail(f"svt_reconstruct d={d} p={p} m={m}: max |diff| "
                 f"{err.max().item():.3g} > {RECON_RTOL} * sum|qu s||vt|")
        if not same_bits(k, again):
            fail(f"svt_reconstruct d={d} p={p} m={m}: two launches differ")
        if (d, m) == (D, T):
            info["svt_reconstruct"] = dict(args=(qu, s, vt),
                                           err=err.max().item())
    log(f"svt_reconstruct: within {RECON_RTOL} x sum|qu s||vt| of its "
        f"plain version and two launches bitwise equal at d=8192 "
        f"p={p_main} m=128 (plan {k_recon.plan(D, p_main, T, sms)}) and every d "
        f"in {EDGE_D}, p in {EDGE_P}, m in {EDGE_T}")
    return info


def check_shard_shapes(dev, gen) -> None:
    """The four kernels of the sharded engine's path at a rank's shapes
    when T 128 is split over SHARD_RANKS ranks (n_local 64), against their
    plain versions, and against the full-width launches they stand in
    for: gauss_sketch on a (8192, 64) block at row_offset 64 (the two
    blocks' sketches sum to the full sketch within SKETCH_RTOL),
    svt_reconstruct with the rank's (24, 64) columns of V^T (bitwise the
    full reconstruction's columns), amtl_event_batch on a (8192, 64)
    block with another rank's events at the sentinel 64 (bitwise its plain
    version, and the owned columns and undo rows bitwise the full-width
    launch's), lstsq_grad on a 64-task block (within GRAD_RTOL of its
    plain version, each row bitwise the full 128-task launch's row)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import amtl_event_batch as k_batch
    from repro_torch.kernels import gauss_sketch as k_sketch
    from repro_torch.kernels import lstsq_grad as k_grad
    from repro_torch.kernels import svt_reconstruct as k_recon

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def same_bits(a, b) -> bool:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    n_local = T // SHARD_RANKS
    p = min(RANK + 8, min(D, T))
    w = randn(D, T)
    seed = int(torch.randint(0, 2**31, (1,), generator=gen,
                             device=dev).item())
    full = k_sketch.gauss_sketch(w, seed, 0, p)
    parts = []
    for r in range(SHARD_RANKS):
        blk = w[:, r * n_local:(r + 1) * n_local].contiguous()
        k = k_sketch.gauss_sketch(blk, seed, r * n_local, p)
        want = ref.gauss_sketch_ref(blk, seed, r * n_local, p)
        scale = blk.abs() @ ref.gauss_omega_ref(n_local, p, seed,
                                                 r * n_local, dev).abs()
        if not bool(((k - want).abs() <= SKETCH_RTOL * scale).all()):
            fail(f"gauss_sketch on the ({D}, {n_local}) block at row_offset "
                 f"{r * n_local}: beyond {SKETCH_RTOL} x sum|w||omega|")
        parts.append(k)
    scale = w.abs() @ ref.gauss_omega_ref(T, p, seed, 0, dev).abs()
    if not bool(((sum(parts) - full).abs() <= SKETCH_RTOL * scale).all()):
        fail("gauss_sketch: the blocks' sketches do not sum to the full "
             f"sketch within {SKETCH_RTOL} x sum|w||omega|")

    qu, vt = randn(D, p), randn(p, T)
    s = torch.rand(p, generator=gen, device=dev) * 3.0
    full = k_recon.svt_reconstruct(qu, s, vt)
    for r in range(SHARD_RANKS):
        cols = slice(r * n_local, (r + 1) * n_local)
        vt_loc = vt[:, cols].contiguous()
        k = k_recon.svt_reconstruct(qu, s, vt_loc)
        want = ref.svt_reconstruct_ref(qu, s, vt_loc)
        scale = (qu.abs() * s) @ vt_loc.abs()
        if not bool(((k - want).abs() <= RECON_RTOL * scale + 1e-30).all()):
            fail(f"svt_reconstruct with vt ({p}, {n_local}): beyond "
                 f"{RECON_RTOL} x sum|qu s||vt|")
        if not same_bits(k, full[:, cols].contiguous()):
            fail(f"svt_reconstruct with vt ({p}, {n_local}): not bitwise "
                 "the full reconstruction's columns")

    tasks = torch.randint(0, T, (BATCH,), generator=gen, device=dev,
                          dtype=torch.int32)
    tasks[7] = tasks[3] = n_local + 1            # a duplicate on rank 1
    tasks[12] = tasks[20] = 2                    # and on rank 0
    v = randn(D, T)
    pc, gc = randn(D, BATCH), randn(D, BATCH)
    eks = torch.rand(BATCH, generator=gen, device=dev)
    fv, fundo = k_batch.amtl_event_batch(v.clone(), pc, gc, tasks, ETA, eks)
    for r in range(SHARD_RANKS):
        cols = slice(r * n_local, (r + 1) * n_local)
        local, owned = ref.shard_local_tasks(tasks, r * n_local, n_local)
        blk = v[:, cols].contiguous()
        kv, kundo = k_batch.amtl_event_batch(blk.clone(), pc, gc, local, ETA,
                                             eks)
        rv, rundo = ref.amtl_event_batch_ref(blk.clone(), pc, gc, local, ETA,
                                             eks)
        torch.cuda.synchronize()
        if not (same_bits(kv, rv) and same_bits(kundo, rundo)):
            fail(f"amtl_event_batch on the ({D}, {n_local}) block with the "
                 f"sentinel {n_local}: not bitwise its plain version")
        if not (same_bits(kv, fv[:, cols].contiguous())
                and same_bits(kundo[owned], fundo[owned])):
            fail(f"amtl_event_batch on the ({D}, {n_local}) block: the owned "
                 "columns or undo rows differ from the full-width launch's")

    xs = torch.randn(T, N_ROWS, D, generator=gen, device=dev)
    ys = torch.randn(T, N_ROWS, generator=gen, device=dev)
    w_rows = randn(BATCH, D)
    gt = torch.randint(0, T, (BATCH,), generator=gen, device=dev,
                       dtype=torch.int32)
    full = k_grad.lstsq_grad_batch(xs, ys, gt, w_rows, None)
    for r in range(SHARD_RANKS):
        lo = r * n_local
        mine = ((gt >= lo) & (gt < lo + n_local)).nonzero().flatten()
        if not mine.numel():
            continue
        ids = (gt[mine] - lo).to(torch.int32)
        blk_x, blk_y = xs[lo:lo + n_local], ys[lo:lo + n_local]
        k = k_grad.lstsq_grad_batch(blk_x, blk_y, ids, w_rows[mine], None)
        want = ref.lstsq_grad_batch_ref(blk_x, blk_y, ids, w_rows[mine], None)
        for e in range(ids.shape[0]):
            xk = blk_x[int(ids[e])].double()
            res = xk @ w_rows[mine][e].double() - blk_y[int(ids[e])].double()
            scale = 2.0 * (xk.abs().T @ res.abs())
            if not bool(((k[e].double() - want[e].double()).abs()
                         <= GRAD_RTOL * scale).all()):
                fail(f"lstsq_grad on the {n_local}-task block: beyond "
                     f"{GRAD_RTOL} x 2 |X|^T |r| of its plain version")
        if not same_bits(k, full[mine]):
            fail(f"lstsq_grad on the {n_local}-task block: rows differ from "
                 "the full 128-task launch's")
    del xs, ys
    torch.cuda.empty_cache()
    log(f"shard shapes (T {T} over {SHARD_RANKS} ranks, n_local {n_local}): "
        f"gauss_sketch on ({D}, {n_local}) at row_offset {n_local} within "
        f"{SKETCH_RTOL} of its plain version, the blocks summing to the "
        f"full sketch; svt_reconstruct with vt ({p}, {n_local}) within "
        f"{RECON_RTOL}, bitwise the full reconstruction's columns; "
        f"amtl_event_batch on ({D}, {n_local}) with the sentinel {n_local} "
        "bitwise its plain version and the full-width launch's owned "
        f"columns; lstsq_grad on a {n_local}-task block within {GRAD_RTOL}, "
        "bitwise the full launch's rows: PASS")


def check_sgd_kernels(dev, gen) -> dict:
    """The minibatch selection and the two least-squares gradient kernels
    against their plain versions on the card."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import lstsq_grad_sampled as k_sampled
    from repro_torch.kernels import sample_mask as k_mask

    info = {}
    cases = 0
    for n in (1, 7, 400, 513):
        for b in (1, SGD_BATCH, 600):
            for n_t in sorted({0, 1, n // 2, n}):
                for seed in (0, 77, 0xFFFFFFFF):
                    block = ref.sample_scalars(n, b, [seed], [n_t])[0]
                    got = k_mask.sample_mask(n, block, dev)
                    want = ref.keep_bits_ref(n, block, dev)
                    if not torch.equal(got, want) \
                            or int(got.sum()) != min(b, n_t):
                        fail(f"sample_mask n={n} b={b} n_t={n_t} "
                             f"seed={seed}: not bitwise, or "
                             f"{int(got.sum())} != min(b, n_t) bits set")
                    cases += 1
    info["sample_mask bits"] = dict(args=(400, ref.sample_scalars(
        400, SGD_BATCH, [77], [240])[0], dev), err=0.0)
    log(f"sample_mask: bitwise against its plain version over {cases} "
        "(n, b, n_t, seed), n = 1, 7, 400, 513, n_t = 0, b >= n_t, b = 1; "
        "exactly min(b, n_t) bits set")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # sample_rows, the engine form: the logistic session's rows (a cohort
    # of 240 in a 399-row buffer, d 8192), an empty cohort, b >= n_t, d 1000
    # (the word path) and x 4 bytes off 16-byte alignment
    for label, n, d, b, n_t, off in (("main", 399, D, SGD_BATCH, 240, 0),
                                     ("n_t=0", 399, D, SGD_BATCH, 0, 0),
                                     ("b>=n_t", 399, D, 300, 250, 0),
                                     ("d=1000", 399, 1000, SGD_BATCH, 399, 0),
                                     ("misaligned", 399, D, SGD_BATCH, 240,
                                      1)):
        x = randn(n * d + off)[off:].view(n, d)
        block = ref.sample_scalars(n, b, [int(torch.randint(
            0, 2**31, (1,), generator=gen, device=dev).item())], [n_t])[0]
        got = k_mask.sample_rows(x, block)
        want = ref.sample_rows_ref(x, block)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"sample_rows {label}: not bitwise its plain version")
        if int(got.any(dim=1).sum()) > min(b, n_t):
            fail(f"sample_rows {label}: more than min(b, n_t) rows kept")
        if label == "main":
            info["sample_mask"] = dict(args=(x, block), err=0.0)
    log("sample_rows (sample_mask's engine form): bitwise against "
        "where(keep_bits, x, 0) at the logistic session's (399, 8192) with "
        "240 valid rows, n_t = 0, b >= n_t, d = 1000, x misaligned")

    # (label, n, d, batch_size, n_t): the main shape (a cohort of 240 rows
    # in a 399-row buffer), d = 1000, a ragged count, a saturated
    # minibatch, an empty cohort.
    for label, n, d, b, n_t in (("main", 399, D, SGD_BATCH, 240),
                                ("d=1000", 399, 1000, SGD_BATCH, 399),
                                ("ragged", 399, D, SGD_BATCH, 81),
                                ("saturated", 399, D, 300, 250),
                                ("n_t=0", 399, D, SGD_BATCH, 0)):
        x, w, y = randn(n, d), randn(d), randn(n)
        seed = int(torch.randint(0, 2**31, (1,), generator=gen,
                                 device=dev).item())
        block = ref.sample_scalars(n, b, [seed], [n_t])[0]
        bsz = min(b, n_t)
        scale2 = 2 * float(np.float32(n_t) / np.float32(max(bsz, 1)))
        name, keep = "lstsq_grad_sampled", ref.keep_bits_ref(n, block, dev)
        k1 = k_sampled.lstsq_grad_sampled(x, w, y, block, b)
        k2 = k_sampled.lstsq_grad_sampled(x, w, y, block, b)
        r = ref.lstsq_grad_sampled_masked_ref(x, w, y, seed, b, n_t)
        torch.cuda.synchronize()
        if not torch.equal(k1.view(torch.int32), k2.view(torch.int32)):
            fail(f"{name} {label}: two launches on the same inputs gave "
                 "different bits")
        xk = x[keep].double()
        res = xk @ w.double() - y[keep].double()
        scale = scale2 * (xk.abs().T @ res.abs())
        err = (k1.double() - r.double()).abs()
        if not bool((err <= GRAD_RTOL * scale).all()):
            fail(f"{name} {label}: max |diff| {err.max().item():.3g} > "
                 f"{GRAD_RTOL} * scale2 |X_K|^T |r_K|")
        if n_t == 0 and bool(k1.any()):
            fail(f"{name} {label}: n_t = 0 must give exactly zero")
        if label == "main":
            info[name] = dict(args=(x, w, y, block, b), err=err.max().item())
    log(f"lstsq_grad_sampled (one event, B = 1): within {GRAD_RTOL} x scale2 "
        "|X_K|^T |r_K| of its plain version (main 240 of 399 rows at "
        "d=8192, d=1000, ragged n_t, saturated b, n_t=0 exactly zero); two "
        "launches give the same bits")
    single = info["lstsq_grad_sampled"]
    info["lstsq_grad_sampled"] = check_sampled_batch(dev, gen)
    info["lstsq_grad_sampled"]["single"] = single
    return info


def sampled_batch_inputs(gen, dev, num_t: int, d: int, b: int, events: int,
                         tasks=None, n_ts=None, n: int = 399) -> tuple:
    """A batch of `events` minibatch-gradient events on `num_t` ragged
    cohorts of an n-row buffer (cohort sizes 80..399 unless `n_ts`),
    on random or given tasks: (xs, ys, tasks, w_rows, scalars, b) with the
    scalar blocks (B, 4) uint32 on the card, and their host copy."""
    import torch
    from repro_torch.kernels import ref
    rng = np.random.default_rng(int(torch.randint(
        0, 2**31, (1,), generator=gen, device=dev).item()))
    if n_ts is None:
        n_ts = rng.integers(COHORT_LO, n + 1, num_t)
    if tasks is None:
        tasks = rng.integers(0, num_t, events)
        tasks[-1] = tasks[0]              # at least one duplicate
    xs = torch.randn(num_t, n, d, generator=gen, device=dev)
    ys = torch.randn(num_t, n, generator=gen, device=dev)
    w_rows = torch.randn(events, d, generator=gen, device=dev)
    seeds = rng.integers(0, 2**32, events, dtype=np.uint64)
    picked = [ref.task_index(int(t), num_t) for t in tasks]
    host = ref.sample_scalars(n, b, seeds, np.asarray(n_ts)[picked])
    return (xs, ys, torch.as_tensor(tasks, dtype=torch.int32, device=dev),
            w_rows, torch.from_numpy(host).to(dev), b), host


def check_sampled_batch(dev, gen) -> dict:
    """The batched minibatch gradient (one launch for B events) against its
    plain version per event, row e bitwise the B = 1 launch of event e and
    the single-event call, two launches bitwise.  Returns the main case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import lstsq_grad_sampled as k_sampled

    one_task = np.full(BATCH, 7)
    # (label, T, d, b, B, tasks, n_ts): the main batch (the run's duplicate
    # tasks, ragged n_t, a 399-row buffer, d 8192), d = 1000, a saturated
    # b = 300 >= n_t, empty cohorts, B = 1, all 32 events on one task, ids
    # outside [0, T) (picked as the reference's dynamic index picks them).
    n_ts_zero = np.array([0, 250, 0, 399, 81, 0, 33, 0])
    outside = np.array([-1, 16, 19, -17, -2, 3, 16, -16])
    cases = (("main", T, D, SGD_BATCH, BATCH, None, None),
             ("d=1000", 16, 1000, SGD_BATCH, BATCH, None, None),
             ("saturated b=300", 16, D, 300, BATCH, None, None),
             ("n_t=0", 8, D, SGD_BATCH, BATCH, None, n_ts_zero),
             ("B=1", 16, D, SGD_BATCH, 1, None, None),
             ("one task", 16, D, SGD_BATCH, BATCH, one_task, None),
             ("ids outside [0, T)", 16, D, SGD_BATCH, 8, outside, None))
    main = None
    for label, num_t, d, b, events, tasks, n_ts in cases:
        args_, host = sampled_batch_inputs(gen, dev, num_t, d, b, events,
                                           tasks, n_ts)
        xs, ys, ts, w_rows, scal, _ = args_
        g1 = k_sampled.lstsq_grad_sampled_batch(*args_)
        g2 = k_sampled.lstsq_grad_sampled_batch(*args_)
        want = ref.lstsq_grad_sampled_batch_ref(*args_)
        torch.cuda.synchronize()
        if not torch.equal(g1.view(torch.int32), g2.view(torch.int32)):
            fail(f"lstsq_grad_sampled batch {label}: two launches on the "
                 "same inputs gave different bits")
        worst = 0.0
        for e in range(events):
            t = ref.task_index(int(ts[e]), num_t)
            n_t = int(host[e, 3])
            keep = ref.keep_bits_ref(xs.shape[1], host[e], dev)
            xk = xs[t][keep].double()
            res = xk @ w_rows[e].double() - ys[t][keep].double()
            s2 = 2 * float(np.float32(n_t) / np.float32(max(min(b, n_t), 1)))
            scale = s2 * (xk.abs().T @ res.abs())
            err = (g1[e].double() - want[e].double()).abs()
            if not bool((err <= GRAD_RTOL * scale).all()):
                fail(f"lstsq_grad_sampled batch {label} event {e}: max |diff|"
                     f" {err.max().item():.3g} > {GRAD_RTOL} * scale2 "
                     "|X_K|^T |r_K|")
            if n_t == 0 and bool(g1[e].any()):
                fail(f"lstsq_grad_sampled batch {label} event {e}: n_t = 0 "
                     "must give exactly zero")
            worst = max(worst, err.max().item())
            alone = k_sampled.lstsq_grad_sampled_batch(
                xs, ys, ts[e:e + 1], w_rows[e:e + 1], scal[e:e + 1], b)
            single = k_sampled.lstsq_grad_sampled(xs[t], w_rows[e], ys[t],
                                                  host[e], b)
            if not (torch.equal(alone[0].view(torch.int32),
                                g1[e].view(torch.int32))
                    and torch.equal(single.view(torch.int32),
                                    g1[e].view(torch.int32))):
                fail(f"lstsq_grad_sampled batch {label}: row {e} differs "
                     "from the B = 1 launch of its event")
        if label == "main":
            main = dict(args=args_, host=host, err=worst)
    log(f"lstsq_grad_sampled batched: within {GRAD_RTOL} x scale2 "
        "|X_K|^T |r_K| of its plain version event by event (main B 32 on "
        "399-row ragged cohorts at d=8192 with the run's duplicates, d=1000, "
        "saturated b=300, n_t=0 exactly zero, B=1, one task, ids outside "
        "[0, T)); row e bitwise "
        "the B = 1 launch and the single-event call of event e; two launches "
        "give the same bits")
    return main


def check_lstsq_grad(dev, gen) -> dict:
    """The full gradient (one launch for B events) against its plain
    version per event, within GRAD_RTOL x 2 |X_K|^T |r_K| (K the valid
    rows); row e bitwise the B = 1 launch of event e (the task form, the
    batched form at B = 1, and the one-buffer form with its host count);
    two launches bitwise; n_t = 0 exactly +0.  Returns the main case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import lstsq_grad as k_grad

    rng = np.random.default_rng(int(torch.randint(
        0, 2**31, (1,), generator=gen, device=dev).item()))
    zero_some = np.array([0, 256, 0, 17, 16, 0, 255, 1])
    outside = np.array([-1, 16, 19, -17, -2, 3, 16, -16])
    # (label, T, n, d, B, tasks, row counts: None uniform, "ragged" drawn
    # in [0, n] with 0 and n among them, or given)
    cases = (("main uniform", 40, N_ROWS, D, BATCH, None, None),
             ("main ragged", 40, N_ROWS, D, BATCH, None, "ragged"),
             ("n=250 (not a multiple of the group)", 16, 250, D, BATCH, None,
              "ragged"),
             ("d=1000", 16, N_ROWS, 1000, BATCH, None, "ragged"),
             ("one task", 16, N_ROWS, D, BATCH, np.full(BATCH, 7), "ragged"),
             ("ids outside [0, T)", 16, N_ROWS, D, 8, outside, "ragged"),
             ("B=1", 16, N_ROWS, D, 1, None, "ragged"),
             ("n_t=0", 8, N_ROWS, D, BATCH, None, zero_some))
    main = None
    for label, num_t, n, d, events, tasks, counts in cases:
        if tasks is None:
            tasks = rng.integers(0, num_t, events)
            tasks[-1] = tasks[0]              # at least one duplicate
        if isinstance(counts, str):
            counts = rng.integers(0, n + 1, num_t)
            counts[:2] = (0, n)
        xs = torch.randn(num_t, n, d, generator=gen, device=dev)
        ys = torch.randn(num_t, n, generator=gen, device=dev)
        w_rows = torch.randn(events, d, generator=gen, device=dev)
        ts = torch.as_tensor(tasks, dtype=torch.int32, device=dev)
        rc = None if counts is None else torch.as_tensor(
            counts, dtype=torch.int32, device=dev)
        args_ = (xs, ys, ts, w_rows, rc)
        g1 = k_grad.lstsq_grad_batch(*args_)
        g2 = k_grad.lstsq_grad_batch(*args_)
        want = ref.lstsq_grad_batch_ref(*args_)
        torch.cuda.synchronize()
        if not torch.equal(g1.view(torch.int32), g2.view(torch.int32)):
            fail(f"lstsq_grad batch {label}: two launches on the same inputs "
                 "gave different bits")
        worst = 0.0
        for e in range(events):
            t = ref.task_index(int(tasks[e]), num_t)
            n_t = n if counts is None else int(counts[t])
            xk = xs[t, :n_t].double()
            res = xk @ w_rows[e].double() - ys[t, :n_t].double()
            scale = 2.0 * (xk.abs().T @ res.abs())
            err = (g1[e].double() - want[e].double()).abs()
            if not bool((err <= GRAD_RTOL * scale).all()):
                fail(f"lstsq_grad batch {label} event {e}: max |diff| "
                     f"{err.max().item():.3g} > {GRAD_RTOL} * 2 |X_K|^T "
                     "|r_K|")
            if n_t == 0 and bool(g1[e].view(torch.int32).any()):
                fail(f"lstsq_grad batch {label} event {e}: n_t = 0 must give "
                     "exactly +0")
            worst = max(worst, err.max().item())
            forms = (k_grad.lstsq_grad_task(xs, ys, int(tasks[e]), w_rows[e],
                                            rc),
                     k_grad.lstsq_grad_batch(xs, ys, ts[e:e + 1],
                                             w_rows[e:e + 1], rc)[0],
                     k_grad.lstsq_grad(xs[t], w_rows[e], ys[t], n_t))
            for form, g in zip(("task", "batch B = 1", "one buffer"), forms):
                if not torch.equal(g.view(torch.int32),
                                   g1[e].view(torch.int32)):
                    fail(f"lstsq_grad batch {label}: row {e} differs from "
                         f"the {form} launch of its event")
        if label == "main uniform":
            main = dict(err=worst)
    log(f"lstsq_grad batched: within {GRAD_RTOL} x 2 |X_K|^T |r_K| of its "
        "plain version event by event (main B 32 on 256-row tasks at d=8192, "
        "uniform and ragged n_t from 0 to n, n = 250, d = 1000, one task, ids "
        "outside [0, T), B = 1, n_t = 0 exactly +0); row e bitwise the task, "
        "batched and one-buffer B = 1 launches of event e; two launches give "
        "the same bits")
    return main


def bits(x):
    """x's raw bits, as integers of its width."""
    import torch
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def bf16_ulp(x):
    """One bf16 ulp (8 significant bits) of |x|, in float32."""
    import torch
    _, e = torch.frexp(x.abs().clamp_min(torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(x), e - 8)


def check_l21_km_kernels(dev, gen) -> dict:
    """The l2,1 prox and the KM update kernels against their plain versions
    on the card: l21_prox at the path's (8192, 128), the bench's (8192,
    64) and edge shapes (a warp a row, a block a row at T 1000, 16-byte and
    scalar loads), zero rows, t 0, t above every row norm, bf16, and two
    launches on one input bitwise; km_update bitwise in float32 and bf16.
    Returns the path's inputs for the timing phase."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import km_update as k_km
    from repro_torch.kernels import l21_prox as k_l21

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    thresh = ref.to_f32(ETA * LAM)
    # (label, d, T, dtype, t): t None is "above every row norm"
    cases = [("path", D, T, "float32", thresh),
             ("bench", D, 64, "float32", thresh),
             ("1x1", 1, 1, "float32", 0.5), ("1023x3", 1023, 3, "float32", 0.5),
             ("600x7", 600, 7, "float32", 0.5),
             ("300x130", 300, 130, "float32", 0.5),
             ("64x1000 (a block a row)", 64, 1000, "float32", 0.5),
             ("zero rows", 600, 7, "float32", 0.5),
             ("t 0", D, T, "float32", 0.0),
             ("t above every norm", 300, 130, "float32", None),
             ("bf16 path", D, T, "bfloat16", thresh),
             ("bf16 600x7", 600, 7, "bfloat16", 0.5),
             ("bf16 300x130", 300, 130, "bfloat16", 0.5),
             ("bf16 64x1000", 64, 1000, "bfloat16", 0.5)]
    info, worst = {}, {}
    for label, d, tt, dt, t in cases:
        w = (2.0 * randn(d, tt)).to(getattr(torch, dt))
        if label == "zero rows":
            w[::7] = 0.0
        if t is None:
            t = 1.01 * float(torch.linalg.vector_norm(w.float(), dim=1).max())
        k1, k2 = k_l21.l21_prox(w, t), k_l21.l21_prox(w, t)
        r = ref.l21_prox_ref(w, t)
        torch.cuda.synchronize()
        if not torch.equal(bits(k1), bits(k2)):
            fail(f"l21_prox {label}: two launches on one input gave "
                 "different bits")
        err = (k1.float() - r.float()).abs()
        if dt == "float32":
            ok = bool(err.max() <= L21_RTOL * w.abs().max())
        else:
            ok = bool((err <= bf16_ulp(torch.maximum(k1.float().abs(),
                                                     r.float().abs()))).all())
        special = {"zero rows": lambda: not k1[::7].any(),
                   "t 0": lambda: torch.equal(bits(k1), bits(w)),
                   "t above every norm": lambda: not k1.any()}
        if k1.dtype != w.dtype or not ok \
                or not special.get(label, lambda: True)():
            fail(f"l21_prox {label} {dt}: max |diff| {err.max().item():.3g} "
                 f"(max|w| {w.abs().max().item():.3g}), or dtype {k1.dtype}, "
                 "or its edge case wrong")
        worst[dt] = max(worst.get(dt, 0.0), err.max().item())
        if label in ("path", "bench"):
            info["l21_prox" if label == "path" else "l21_prox bench"] = \
                dict(args=(w, t), err=err.max().item())
    log(f"l21_prox: float32 within {L21_RTOL} x max|w| of its plain version "
        f"(max |diff| {worst['float32']:.3g}), bf16 within one bf16 ulp "
        f"(max |diff| {worst['bfloat16']:.3g}), at (8192, 128), (8192, 64), "
        "1x1, 1023x3, 600x7, 300x130, 64x1000, zero rows, t 0 (w exactly), "
        "t above every norm (zeros); two launches give the same bits")

    eta_k = 0.37
    for dt in ("float32", "bfloat16"):
        for shape in ((D,), (D, 1), (D, T), (300, 130), (7, 1)):
            v, p, g = (randn(*shape).to(getattr(torch, dt)) for _ in range(3))
            k = k_km.km_update(v, p, g, ETA, eta_k)
            r = ref.km_update_ref(v, p, g, ETA, eta_k)
            torch.cuda.synchronize()
            if k.dtype != v.dtype or not torch.equal(bits(k), bits(r)):
                fail(f"km_update {shape} {dt}: not bitwise (max |diff| "
                     f"{(k.float() - r.float()).abs().max().item():.3g})")
            if dt == "float32" and shape in ((D,), (D, T)):
                slot = "km_update column" if shape == (D,) \
                    else "km_update block"
                info[slot] = dict(args=(v, p, g, ETA, eta_k), err=0.0)
    log("km_update: bitwise against its plain version in float32 and bf16 at "
        "(8192,), (8192, 1), (8192, 128), (300, 130), (7, 1)")
    return info


def keep_mask(sq: int, skv: int, causal: bool, window, q_offset: int,
              kv_len, dev):
    """(Sq, Skv) bool: whether query row r keeps key j, by mha_ref's
    masks."""
    import torch
    i = q_offset + torch.arange(sq, device=dev)[:, None]
    j = torch.arange(skv, device=dev)[None, :]
    keep = (j < (skv if kv_len is None else kv_len)).expand(sq, skv)
    if causal:
        keep = keep & (j <= i)
    if window:
        keep = keep & (j > i - window)
    return keep.contiguous()


def row_err(got, want, rows, relative: bool = True) -> float:
    """Max over the (batch, row, head) rows whose query row is set in
    `rows` (Sq,) of max |got - want| along hd, over max |want| along hd if
    `relative`."""
    d = (got.float() - want.float()).abs().amax(-1)
    if relative:
        d = d / want.float().abs().amax(-1).clamp_min(1e-30)
    return d[:, rows].max().item() if bool(rows.any()) else 0.0


def masked_attention(q, k, v, keep, softcap):
    """Dense softmax attention with an explicit (Sq, Skv) keep mask, in
    float32, out in q's dtype; a row with no kept key gives 0.  The flash
    gate's controls: the served masks with a tile changed."""
    import torch
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    kf, vf = k.float(), v.float()
    outs = []
    for r0 in range(0, sq, 1024):
        qg = q[:, r0:r0 + 1024].float().reshape(b, -1, hkv, h // hkv, hd)
        x = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
        x = x.masked_fill(~keep[r0:r0 + 1024], float("-inf"))
        p = torch.softmax(x, dim=-1).nan_to_num(0.0)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p, vf)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, -1, h, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def flash_controls(label: str, args_, plain, keep, limit: float) -> str:
    """At a served bf16 shape: the dense plain version with the true masks
    must pass the row gate against `plain` (the route's plain version), and
    with a key tile left out (prefill global, decode ring) or the window's
    edge a tile further out (prefill local) must fail it."""
    q, k, v, kw = args_
    sq, skv = q.shape[1], k.shape[1]
    rows = keep.any(1)
    if label == "prefill local":
        what = "window edge a tile wide"
        bad = keep_mask(sq, skv, kw["causal"], kw["window"] + SM90_CHUNK,
                        kw["q_offset"], kw["kv_len"], q.device)
    else:
        t0 = (skv // 2) // SM90_CHUNK * SM90_CHUNK
        what = f"keys {t0}-{t0 + SM90_CHUNK - 1} left out"
        bad = keep.clone()
        bad[:, t0:t0 + SM90_CHUNK] = False
    sound = row_err(masked_attention(q, k, v, keep, kw["softcap"]), plain,
                    rows)
    wrong = row_err(masked_attention(q, k, v, bad, kw["softcap"]), plain,
                    rows)
    if not sound <= limit:
        fail(f"flash control {label}: the dense plain version with the true "
             f"masks is {sound:.3g} from the route's plain version > {limit}")
    if not wrong > limit:
        fail(f"flash control {label} ({what}): {wrong:.3g} <= {limit}: the "
             f"row gate does not see it")
    return f"{label}: true masks {sound:.3g}, {what} {wrong:.3g}"


def check_flash_kernel(dev, gen) -> dict:
    """The flash-attention kernels against their plain versions on the
    card, in float32 and bfloat16: at the served shapes (prefill of a global
    and of a local layer, decode on the ring and on the global cache), and
    at edge cases, each route that takes a case forced in turn, by FLASH_TOL
    and by FLASH_ROW_TOL (with its controls at the served shapes); the
    (S, H, hd) entry point.  Returns the bfloat16 served cases (on the
    routes the wrapper picks) for the timing phase."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import flash_attention as k_flash
    s, s_max, w = SERVE_PROMPT, SERVE_PROMPT + SERVE_GEN, 4096
    # (label, B, Sq, Skv, H, Hkv, hd, causal, window, softcap, q_offset,
    #  kv_len)
    cases = [
        ("prefill global", 2, s, s, 8, 4, 256, True, None, 50.0, 0, None),
        ("prefill local", 2, s, s, 8, 4, 256, True, w, 50.0, 0, None),
        ("decode ring", 2, 1, w, 8, 4, 256, False, None, 50.0, s + 10, w),
        ("decode global", 2, 1, s_max, 8, 4, 256, False, None, 50.0, s + 10,
         s + 11),
        ("S 37 < 64, Hkv 1, hd 64", 1, 37, 37, 4, 1, 64, True, None, None, 0,
         None),
        ("window 300 >= S 200", 3, 200, 200, 4, 2, 64, True, 300, 30.0, 0,
         None),
        ("hd 72, window 16", 1, 130, 130, 2, 2, 72, True, 16, None, 0, None),
        ("q_offset 48, kv_len 64", 1, 16, 80, 4, 2, 128, True, 32, None, 48,
         64),
        ("non-causal, kv_len 100", 2, 65, 129, 4, 4, 32, False, None, 50.0, 0,
         100),
        ("Sq 1, kv_len 1", 2, 1, 64, 8, 4, 256, False, None, 50.0, 0, 1),
        ("decode, last splits past the causal edge", 2, 1, w, 8, 4, 256, True,
         None, 50.0, 100, w),
        ("decode, window 500 empties splits", 2, 1, w, 8, 4, 256, False, 500,
         50.0, 3000, w),
        ("hd 128", 2, 300, 300, 8, 4, 128, True, None, 50.0, 0, None),
        ("hd 64, window 64", 1, 200, 200, 4, 2, 64, True, 64, None, 0, None),
        ("Sq 129", 1, 129, 129, 8, 4, 256, True, None, 50.0, 0, None),
        ("GQA 8:1", 1, 300, 300, 8, 1, 128, True, None, None, 0, None),
        ("GQA 8:1 decode", 2, 1, 1000, 8, 1, 256, False, None, 50.0, 900, 901),
        ("Sq 3 decode, causal", 2, 3, 1000, 8, 4, 256, True, None, 50.0, 900,
         903),
        ("q_offset 256, kv_len 456", 1, 200, 456, 8, 4, 256, True, None, 50.0,
         256, 456),
        # rows 164-255 keep no key (past kv_len, behind the window)
        ("rows with no kept key", 1, 256, 256, 8, 4, 256, True, 64, 50.0, 0,
         100),
        # 64 rows a kv head; rows 23-31 keep no key
        ("Sq 32, rows with no kept key", 2, 32, 256, 8, 4, 256, True, 64,
         50.0, 140, 100),
    ]
    served, worst, row_worst, split_worst, runs = {}, {}, {}, {}, 0
    controls, empty = [], 0
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for label, b, sq, skv, h, hkv, hd, causal, window, cap, qo, kvl \
                in cases:
            q = torch.randn(b, sq, h, hd, generator=gen, device=dev).to(dt)
            k = torch.randn(b, skv, hkv, hd, generator=gen, device=dev).to(dt)
            v = torch.randn(b, skv, hkv, hd, generator=gen, device=dev).to(dt)
            kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo,
                      kv_len=kvl)
            keep = keep_mask(sq, skv, causal, window, qo, kvl, dev)
            rows = keep.any(1)
            want = ref.mha_ref(q, k, v, causal=causal, window=window,
                               softcap=cap, q_offset=qo, kv_valid_len=kvl)
            plains = {}
            for route in k_flash.ROUTES:
                if not k_flash.accepts(route, dt, sq, h, hkv, hd):
                    continue
                got = k_flash.flash_attention(q, k, v, route=route, **kw)
                err = row_err(got, want, rows, relative=False)
                if got.dtype != dt or not err <= FLASH_TOL[dt_name]:
                    fail(f"flash_attention {label} {dt_name} route {route}: "
                         f"max |diff| {err:.3g} > {FLASH_TOL[dt_name]} (or "
                         f"dtype {got.dtype})")
                if route == "sm90":
                    plains[route] = ref.mha_ref(
                        q, k, v, causal=causal, window=window, softcap=cap,
                        q_offset=qo, kv_valid_len=kvl, kv_chunk=SM90_CHUNK,
                        p_dtype=torch.bfloat16)
                else:
                    plains[route] = want
                rerr = row_err(got, plains[route], rows)
                if not rerr <= FLASH_ROW_TOL[dt_name]:
                    fail(f"flash_attention {label} {dt_name} route {route}: "
                         f"max |diff| {rerr:.3g} of a row's max |o| > "
                         f"{FLASH_ROW_TOL[dt_name]}")
                if not bool(rows.all()):
                    if bool(got[:, ~rows].any()):
                        fail(f"flash_attention {label} {dt_name} route "
                             f"{route}: a row with no kept key is not 0")
                    empty += 1
                key = (route, dt_name)
                worst[key] = max(worst.get(key, 0.0), err)
                row_worst[key] = max(row_worst.get(key, 0.0), rerr)
                runs += 1
                if route == "split":
                    # the kernel's own split plan, computed the plain way
                    ns, chunk = k_flash.split_plan_for(
                        q, k, skv if kvl is None else kvl)
                    plain = ref.mha_split_ref(
                        q, k, v, causal=causal, window=window, softcap=cap,
                        q_offset=qo, kv_valid_len=kvl, num_splits=ns,
                        chunk=chunk)
                    err = (got.float() - plain.float()).abs().max().item()
                    if not err <= FLASH_TOL[dt_name]:
                        fail(f"flash_attention {label} {dt_name}: split "
                             f"against mha_split_ref ({ns} splits of "
                             f"{chunk}) max |diff| {err:.3g}")
                    split_worst[dt_name] = max(split_worst.get(dt_name, 0.0),
                                               err)
            if dt_name == "bfloat16" and label in ("prefill global",
                                                   "prefill local",
                                                   "decode ring",
                                                   "decode global"):
                got = k_flash.flash_attention(q, k, v, **kw)
                err = (got.float() - want.float()).abs().max().item()
                served[label] = dict(args=(q, k, v, kw), err=err)
                if label != "decode global":
                    route = k_flash.route(dt, b, sq, skv, h, hkv, hd,
                                          skv if kvl is None else kvl)
                    controls.append(flash_controls(
                        label, (q, k, v, kw), plains[route], keep,
                        FLASH_ROW_TOL[dt_name]))
    # the (S, H, hd) entry point against the O(S^2) oracle
    q, k, v, _ = served["prefill local"]["args"]
    got = ops.flash_attention(q[0], k[0], v[0], causal=True, window=4096,
                              softcap=50.0)
    want = ref.sliding_flash_attention_ref(
        q[0], k[0].repeat_interleave(2, dim=1),
        v[0].repeat_interleave(2, dim=1), window=4096, softcap=50.0)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= FLASH_TOL["bfloat16"]:
        fail(f"ops.flash_attention (S 5000, H 8, Hkv 4, hd 256, window "
             f"4096): max |diff| {err:.3g} against the O(S^2) oracle")
    log(f"flash_attention: {runs} (case, dtype, route) runs within "
        f"{FLASH_TOL} of mha_ref and {FLASH_ROW_TOL} of a row's max |o| "
        f"(sm90 against mha_ref in 64-key chunks with P in bf16); max |diff| "
        "by route and dtype: "
        + ", ".join(f"{r} {d} {e:.3g}" for (r, d), e in sorted(worst.items()))
        + "; of a row's max |o|: "
        + ", ".join(f"{r} {d} {e:.3g}"
                    for (r, d), e in sorted(row_worst.items()))
        + "; split against mha_split_ref with the kernel's plan: "
        + ", ".join(f"{d} {e:.3g}" for d, e in sorted(split_worst.items()))
        + f"; rows with no kept key exactly 0 in {empty} runs of every route"
        + "; row-gate controls (bf16, dense plain version against the "
        "route's): " + "; ".join(controls)
        + "; at the served shapes (B 2, S 5000, H 8, Hkv 4, hd 256: prefill "
        "with window 4096 and none, softcap 50; decode on a 4096-slot ring "
        "and a 5032-slot cache) and edge cases (S 37, 129; Hkv 1, GQA 8:1; hd "
        "64/72/128; window >= S, window emptying splits; q_offset; kv_len 1, "
        "64, 100; splits past the causal edge; Sq 3 decode; rows with no "
        "kept key); ops.flash_attention against the O(S^2) oracle")
    return {"flash_attention": dict(served["prefill global"], served=served)}


def wkv_inputs(gen, dev, b, ell, h, d, dtype, log_w0, state_scale):
    """r, k, v (B, L, H, D) in `dtype`, the decay w = exp(-exp(log_w0 +
    0.5 N)) float32 (-6: the served init's w ~ 0.9975; 1.9: w near 1e-3),
    u (H, D) and a state (B, H, D, D), on the card."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    r, k, v = ((0.5 * randn(b, ell, h, d)).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(log_w0 + 0.5 * randn(b, ell, h, d)))
    return r, k, v, w, 0.5 * randn(h, d), state_scale * randn(b, h, d, d)


def wkv_row_err(got, want) -> float:
    """Largest relative error of an output row: max over (b, t, h) of the
    row's max |diff| over the row's max |want| (rows of want all zero
    compare absolutely)."""
    d = (got.float() - want.float()).abs().amax(-1)
    return float((d / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def wkv_chunked_readings(out, state, plain, exact) -> dict:
    """(row, state) readings of a chunked-route output and final state
    against the plain version's and the exact recurrence's (out, state)."""
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp_min(1e-30))
    return {name: (wkv_row_err(out, ref_out), rel(state, ref_state))
            for name, (ref_out, ref_state) in (("plain", plain),
                                               ("exact", exact))}


def wkv_gate_fails(readings: dict) -> dict:
    """For each yardstick, whether a reading exceeds its limit."""
    return {name: not (row <= WKV_CHUNKED_ROW_TOL[name]
                       and st <= WKV_CHUNKED_STATE_TOL[name])
            for name, (row, st) in readings.items()}


def wkv_controls(args_, plain, exact) -> dict:
    """The chunked gate's controls, built from the plain version on the
    same inputs: the state dropped at the sub-chunk boundary nearest the
    middle, the decays read one token late, the bonus left out.  Returns
    each control's readings."""
    import torch
    from repro_torch.kernels import ref
    r, k, v, w, u, s0 = args_
    ell = r.shape[1]
    cut = max(16, (ell // 2) // 16 * 16)
    o1, _ = ref.wkv_subchunk_ref(r[:, :cut], k[:, :cut], v[:, :cut],
                                 w[:, :cut], u, s0)
    o2, s2 = ref.wkv_subchunk_ref(r[:, cut:], k[:, cut:], v[:, cut:],
                                  w[:, cut:], u, None)
    late = torch.cat([w[:, :1], w[:, :-1]], dim=1)
    ol, sl = ref.wkv_subchunk_ref(r, k, v, late, u, s0)
    ob, sb = ref.wkv_subchunk_ref(r, k, v, w, torch.zeros_like(u), s0)
    controls = {"state dropped": (torch.cat([o1, o2], 1), s2),
                "decays one token late": (ol, sl),
                "bonus left out": (ob, sb)}
    return {name: wkv_chunked_readings(o.to(r.dtype), st, plain, exact)
            for name, (o, st) in controls.items()}


def check_rwkv_chunked(dev, gen) -> dict:
    """The chunked route against its plain version and the exact
    recurrence: the served prefill, a non-zero state, the edge lengths
    through the forced route, w near 1e-3 and 1e-6, w = 1, two launches
    bitwise, and the controls, which must fail the gate.  Returns the
    worst readings."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as k_rwkv
    p = SERVE_PROMPT
    # (label, B, L, H, log_w0 (None: w = 1), state scale, controls)
    cases = [("prefill", 2, p, 40, -6.0, 0.0, True),
             ("prefill from a state", 2, 1000, 40, -6.0, 1.0, False)]
    cases += [(f"L {ell}", 2, ell, 3, -1.0, 0.3, ell == 200)
              for ell in (1, 15, 16, 17, 63, 64, 65, 200)]
    cases += [("w near 1e-3", 1, 200, 3, 1.9, 0.3, False),
              ("w near 1e-6", 1, 200, 3, 2.63, 0.3, False),
              ("w = 1", 1, 300, 3, None, 0.3, False)]
    worst, controls, served = {}, {}, None
    for label, b, ell, h, log_w0, scale, with_controls in cases:
        args_ = wkv_inputs(gen, dev, b, ell, h, 64, torch.bfloat16,
                           -6.0 if log_w0 is None else log_w0, scale)
        if log_w0 is None:
            args_ = args_[:3] + (torch.ones_like(args_[3]),) + args_[4:]
        r, k, v, w, u, s0 = args_
        state = s0.clone()
        out = k_rwkv.wkv(r, k, v, w, u, state, route="chunked")
        state2 = s0.clone()
        out2 = k_rwkv.wkv(r, k, v, w, u, state2, route="chunked")
        plain = ref.wkv_subchunk_ref(r, k, v, w, u, s0)
        exact = ref.wkv_ref(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        if out.dtype != torch.bfloat16 or not bool(
                torch.isfinite(out).all() & torch.isfinite(state).all()):
            fail(f"rwkv6_scan chunked {label}: output of dtype {out.dtype} "
                 "or not finite")
        if not (torch.equal(out, out2) and torch.equal(state, state2)):
            fail(f"rwkv6_scan chunked {label}: two launches differ")
        readings = wkv_chunked_readings(out, state, plain, exact)
        if any(wkv_gate_fails(readings).values()):
            fail(f"rwkv6_scan chunked {label}: (row, state) readings "
                 f"{readings} above the limits {WKV_CHUNKED_ROW_TOL} (row) "
                 f"and {WKV_CHUNKED_STATE_TOL} (state)")
        worst[label] = readings
        if with_controls:
            for name, got in wkv_controls(args_, plain, exact).items():
                if not all(wkv_gate_fails(got).values()):
                    fail(f"rwkv6_scan chunked {label}: the control '{name}' "
                         f"passes the gate ({got})")
                controls[f"{label}: {name}"] = got
        if label == "prefill":
            served = dict(args=args_, err=float(
                (out.float() - exact[0]).abs().max()))
    # ops.rwkv6_scan at a shape of the reference's Pallas tests, in bf16:
    # the route picks the chunked kernel
    g = torch.Generator(device=dev).manual_seed(3)
    r = (0.3 * torch.randn(200, 3, 64, generator=g, device=dev)).bfloat16()
    w = torch.sigmoid(torch.randn(200, 3, 64, generator=g, device=dev))
    u = 0.3 * torch.randn(3, 64, generator=g, device=dev)
    before = k_rwkv.route_counts()["chunked"]
    got = ops.rwkv6_scan(r, r, r, w, u)
    if k_rwkv.route_counts()["chunked"] != before + 1:
        fail("ops.rwkv6_scan (200, 3, 64) bf16 did not take the chunked "
             "route")
    want, _ = ref.wkv_ref(r[None], r[None], r[None], w[None], u, None)
    e_scan = wkv_row_err(got, want[0])
    if not e_scan <= WKV_CHUNKED_ROW_TOL["exact"]:
        fail(f"ops.rwkv6_scan (200, 3, 64) bf16: {e_scan:.3g} of a row "
             f"against wkv_ref > {WKV_CHUNKED_ROW_TOL['exact']}")
    fmt = lambda rd: ", ".join(f"{k} {a:.3g}/{b:.3g}"
                               for k, (a, b) in rd.items())
    log("rwkv6_scan chunked: (row, state) against its plain version and "
        "wkv_ref, two launches bitwise each: "
        + "; ".join(f"{k} {fmt(v)}" for k, v in worst.items())
        + f"; ops.rwkv6_scan (200, 3, 64) bf16 {e_scan:.3g}; controls "
        "(each above a limit against both): "
        + "; ".join(f"{k} {fmt(v)}" for k, v in controls.items()))
    return served


def check_rwkv_kernel(dev, gen) -> dict:
    """The WKV kernel against its plain versions on the card: at the served
    prefill shape against the chunked form the model's CPU path runs, and
    at the decode shape and edge cases against the sequential recurrence,
    output and state; `ops.rwkv6_scan` at a shape of the Pallas tests.
    Returns the served cases (bfloat16) for the timing phase."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as k_rwkv

    def rel(got, want) -> float:
        return float((got.float() - want.float()).abs().max()
                     / want.float().abs().max())

    # (label, B, L, H, D, dtype, log_w0, state scale, plain version)
    p = SERVE_PROMPT
    cases = [("prefill", 2, p, 40, 64, "bfloat16", -6.0, 0.0, "chunked"),
             ("prefill float32", 2, p, 40, 64, "float32", -6.0, 0.0,
              "chunked"),
             ("decode", 2, 1, 40, 64, "bfloat16", -6.0, 1.0, "sequential"),
             ("L 77", 2, 77, 5, 64, "float32", -1.0, 0.3, "sequential"),
             ("D 32", 3, 50, 4, 32, "float32", -2.0, 0.3, "sequential"),
             ("D 32 bf16", 1, 45, 6, 32, "bfloat16", -3.0, 0.3, "sequential"),
             ("w near 1e-3", 1, 40, 3, 64, "float32", 1.9, 0.3,
              "sequential")]
    served, worst = {}, {}
    for label, b, ell, h, d, dt, log_w0, scale, plain in cases:
        r, k, v, w, u, s0 = wkv_inputs(gen, dev, b, ell, h, d,
                                       getattr(torch, dt), log_w0, scale)
        state = s0.clone()
        out = k_rwkv.wkv(r, k, v, w, u, state, route="recurrent")
        if plain == "chunked":
            want, want_state = ref.wkv_chunked_ref(r, k, v, w, u, WKV_CHUNK,
                                                   s0)
        else:
            want, want_state = ref.wkv_ref(r, k, v, w, u, s0)
        want = want.to(r.dtype)
        torch.cuda.synchronize()
        e_out, e_state = rel(out, want), rel(state, want_state)
        if out.dtype != r.dtype or not e_out <= WKV_RTOL[dt] \
                or not bool(torch.isfinite(out).all()):
            fail(f"rwkv6_scan {label}: output {e_out:.3g} of max|out| > "
                 f"{WKV_RTOL[dt]} against the {plain} plain version (or "
                 f"dtype {out.dtype}, or not finite)")
        if plain == "sequential" and not torch.equal(state, want_state):
            fail(f"rwkv6_scan {label}: state not bitwise the sequential "
                 f"plain version's ({e_state:.3g} of max|state|)")
        if not e_state <= WKV_STATE_RTOL:
            fail(f"rwkv6_scan {label}: state {e_state:.3g} of max|state| > "
                 f"{WKV_STATE_RTOL} against the {plain} plain version")
        worst[label] = (e_out, e_state)
        if label in ("prefill", "decode"):
            served[label] = dict(args=(r, k, v, w, u, s0),
                                 err=float((out.float() - want.float())
                                           .abs().max()))
    r = torch.randn(200, 3, 64, generator=gen, device=dev)
    w = torch.sigmoid(torch.randn(200, 3, 64, generator=gen, device=dev))
    u = torch.randn(3, 64, generator=gen, device=dev)
    e_scan = rel(ops.rwkv6_scan(r, r, r, w, u),       # float32: recurrent
                 ref.rwkv6_scan_ref(r, r, r, w, u))
    if not e_scan <= WKV_RTOL["float32"]:
        fail(f"ops.rwkv6_scan (200, 3, 64): {e_scan:.3g} of max|out| against "
             "rwkv6_scan_ref")
    chunked = check_rwkv_chunked(dev, gen)
    log("rwkv6_scan recurrent: output and state against the chunked plain "
        "version at "
        f"the served prefill (B 2, L {p}, H 40, D 64; bf16 and float32) and "
        "against the sequential one at decode (L 1, non-zero state), L 77, "
        "D 32 (float32 and bf16) and w near 1e-3, state bitwise there; "
        "(output, state) relative errors "
        + ", ".join(f"{k} {a:.3g}/{b:.3g}" for k, (a, b) in worst.items())
        + f"; ops.rwkv6_scan (200, 3, 64) {e_scan:.3g}")
    return {"rwkv6_scan": dict(chunked, served=served)}


def wkv_cost(args_, route: str) -> tuple[float, list]:
    """(bytes, [(operations, rate), ...]) of one WKV call on `route`.
    Bytes: r, k, v and out in their dtype, w and u float32, the state read
    and written.  Operations a (token, head): `recurrent`, 5 D^2 + 5 D
    float32 (r.S 2 D^2, the decayed state plus k v^T 3 D^2, the bonus
    r.(u k) v 5 D); `chunked`, its own: 2 (2 D^2 + 16 D + 24 D) on the
    tensor cores in TF32 ((r * E).S's hi term and the state step D^2 each,
    A v 16 D, the 16 x 24 scores across blocks 24 D), 2 D^2 in bf16 (S's
    lo term), and 15.5 D float32 on the CUDA cores (8.75 D for the decays
    and scaled rows, 6.75 D for the scores within blocks)."""
    r, _, _, w, u, state = args_
    b, ell, h, d = r.shape
    el = r.element_size()
    nbytes = el * 4 * r.numel() + 4 * (w.numel() + u.numel()
                                       + 2 * state.numel())
    th = b * ell * h
    if route == "chunked":
        return nbytes, [(float(th * 2 * (2 * d * d + 40 * d)),
                         TF32_FLOP_PER_S),
                        (float(th * 2 * d * d), BF16_FLOP_PER_S),
                        (float(th * 15.5 * d), FP32_FLOP_PER_S)]
    return nbytes, [(float(th * (5 * d * d + 5 * d)), FP32_FLOP_PER_S)]


def wkv_bound(args_, route: str) -> tuple[float, str, str]:
    """(bound ms, what bounds it, the parts) of one WKV call on `route`:
    the larger of its bytes over the memory rate and, for each type of
    operation, its count over that type's peak."""
    nbytes, ops_ = wkv_cost(args_, route)
    parts = [(nbytes / HBM_BYTES_PER_S * 1e3, "bytes")] + [
        (f / rate * 1e3, "operations") for f, rate in ops_]
    t, by = max(parts)
    detail = f"{nbytes / 1e6:.1f} MB {parts[0][0] * 1e3:.2f} us; " + \
        "; ".join(f"{f / 1e9:.3f} GFLOP at {rate / 1e12:.0f} TFLOP/s "
                  f"{f / rate * 1e6:.2f} us" for f, rate in ops_)
    return t, by, detail


WKV_SOURCES = {"chunked": "src/repro_torch/csrc/rwkv6_chunked.cu",
               "recurrent": "src/repro_torch/csrc/rwkv6_scan.cu"}


def rwkv_times(info: dict, counts: dict) -> dict:
    """Each WKV route's device time beside its bound, plain version and
    composite: at the served prefill (B 2, L 5000, H 40, D 64, bf16) the
    chunked route and the recurrent one on the same inputs (the A/B), and
    the decode call (L 1) on the recurrent route; then both routes over
    lengths 1 to 256, the evidence for CHUNKED_MIN_LEN.  Returns each
    route's figures for the kernels line; `counts` are the serve's launches
    of each route."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as k_rwkv
    saved = k_rwkv.launches, k_rwkv.route_counts()
    r, k, v, w, u, s0 = info["args"]
    st = s0.clone()
    routes = {}
    chunk_ms = cuda_ms(lambda: k_rwkv.wkv(r, k, v, w, u, st,
                                          route="chunked"))
    rec_ms = cuda_ms(lambda: k_rwkv.wkv(r, k, v, w, u, st,
                                        route="recurrent"), reps=7, inner=3)
    chunk_ms2 = cuda_ms(lambda: k_rwkv.wkv(r, k, v, w, u, st,
                                           route="chunked"))
    sub_ms = cuda_ms(lambda: ref.wkv_subchunk_ref(r, k, v, w, u, s0),
                     reps=3, warmup=1, inner=1, backlog=False)
    seq_ms = cuda_ms(lambda: ref.wkv_ref(r, k, v, w, u, s0), reps=3,
                     warmup=1, inner=1, backlog=False)
    lib_ms = cuda_ms(lambda: ref.wkv_chunked_ref(r, k, v, w, u, WKV_CHUNK,
                                                 s0), reps=7, inner=3)
    for route, ms, plain_ms in (("chunked", chunk_ms, sub_ms),
                                ("recurrent", rec_ms, seq_ms)):
        bnd, by, detail = wkv_bound(info["args"], route)
        routes[route] = dict(source=WKV_SOURCES[route],
                             shape=f"prefill B 2, L {SERVE_PROMPT}, H 40, "
                                   "D 64, bf16",
                             ms=ms, bound_ms=bnd, bound_by=by,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             launches=counts[route])
        log(f"phase 12 rwkv6_scan {route} prefill (B 2, L {SERVE_PROMPT}, "
            f"H 40, D 64, bf16): {ms * 1e3:.2f} us on the device, bound "
            f"{bnd * 1e3:.2f} us by {by} ({detail}); plain {plain_ms:.1f} ms "
            f"({'wkv_subchunk_ref' if route == 'chunked' else 'wkv_ref'}), "
            f"composite {lib_ms * 1e3:.2f} us ({LIBRARY_CALLS['rwkv6_scan']})"
            f", {counts[route]} launches on the rwkv6-3b serve")
    log(f"phase 12 rwkv6_scan A/B at the served prefill, same inputs, in "
        f"turns: chunked {chunk_ms * 1e3:.2f} and {chunk_ms2 * 1e3:.2f} us, "
        f"recurrent {rec_ms * 1e3:.2f} us ({rec_ms / chunk_ms:.2f}x)")
    dec = info["served"]["decode"]
    spec = kernel_spec("rwkv6_scan", dec["args"], None)
    k_ms = cuda_ms(spec["kfn"])
    p_ms = cuda_ms(spec["pfn"], inner=1, backlog=False)
    l_ms = cuda_ms(spec["lib"])
    bnd, by, detail = wkv_bound(dec["args"], "recurrent")
    log(f"phase 12 rwkv6_scan recurrent decode (B 2, L 1, H 40, D 64, bf16):"
        f" {k_ms * 1e3:.2f} us on the device, bound {bnd * 1e3:.2f} us by "
        f"{by} ({detail}), plain {p_ms * 1e3:.1f} us, library "
        f"{l_ms * 1e3:.1f} us ({LIBRARY_CALLS['rwkv6_scan']})")
    routes["recurrent"].update(decode_ms=k_ms, decode_bound_ms=bnd,
                               decode_plain_ms=p_ms, decode_library_ms=l_ms)
    sweep = []
    for ell in (1, 4, 8, 16, 32, 64, 256):
        args_ = wkv_inputs(torch.Generator(device=r.device).manual_seed(ell),
                           r.device, 2, ell, 40, 64, torch.bfloat16, -6.0,
                           0.0)
        st2 = args_[5].clone()
        times = [cuda_ms(lambda rt=rt: k_rwkv.wkv(*args_[:5], st2, route=rt),
                         reps=11) for rt in ("chunked", "recurrent")]
        sweep.append(f"L {ell} {times[0] * 1e3:.2f} / {times[1] * 1e3:.2f}")
    log("phase 12 rwkv6_scan chunked / recurrent us by length (B 2, H 40, D "
        f"64, bf16; CHUNKED_MIN_LEN {k_rwkv.CHUNKED_MIN_LEN}): "
        + ", ".join(sweep))
    k_rwkv.launches = saved[0]
    k_rwkv.launches_chunked, k_rwkv.launches_recurrent = (
        saved[1]["chunked"], saved[1]["recurrent"])
    return routes


FLASH_SOURCES = {r: f"src/repro_torch/csrc/{f}" for r, f in (
    ("sm90", "flash_attention_sm90.cu"), ("split", "flash_decode.cu"),
    ("simt", "flash_attention.cu"))}


def flash_times(served: dict, dev) -> dict:
    """Device time, bound, plain, library and simt times of each flash
    route at its served shapes: `sm90` at the two bfloat16 prefill layers,
    `split` at the two decode caches (L2-cold: the call walks five distinct
    caches in turn, as the 26 layers' caches are met in serving; and warm),
    `simt` at the float32 prefill of phase 11 (B 1, S 5000).  Returns each
    route's figures for the kernels line."""
    import itertools
    import torch
    from repro_torch.kernels import flash_attention as k_flash
    saved = k_flash.launches, k_flash.route_counts()
    routes = {}
    for label in ("prefill global", "prefill local", "decode ring",
                  "decode global"):
        q, k, v, kw = served[label]["args"]
        spec = kernel_spec("flash_attention", (q, k, v, kw), dev)
        bnd, by = bound_ms(spec["nbytes"], spec["flops"], spec["rate"])
        route = k_flash.route(q.dtype, *q.shape[:2], k.shape[1], q.shape[2],
                              k.shape[2], q.shape[3], k.shape[1])
        prep, call, what = flex_library((q, k, v, kw), dev)
        if route == "split":
            caches = [(k, v)] + [(torch.randn_like(k), torch.randn_like(v))
                                 for _ in range(4)]
            ring = itertools.cycle(caches)
            k_ms = cuda_ms(lambda: k_flash.flash_attention(
                q, *next(ring), **kw))
            warm_ms = cuda_ms(spec["kfn"])
            if prep is not None:
                libs = itertools.cycle([prep(q, kc, vc) for kc, vc in caches])
                l_ms = cuda_ms(lambda: call(*next(libs)))
            temp = f"L2-cold over 5 caches ({5 * 2 * k.numel() * 2 / 1e6:.0f}"\
                f" MB), {warm_ms * 1e3:.2f} us L2-warm"
        else:
            k_ms = cuda_ms(spec["kfn"], reps=11)
            if prep is not None:
                args_ = prep(q, k, v)
                l_ms = cuda_ms(lambda: call(*args_), reps=11)
            temp = "each call reads more than the L2 holds"
        if prep is None:
            l_ms = None
        p_ms = cuda_ms(spec["pfn"], reps=5, inner=1, backlog=False)
        simt_ms = cuda_ms(lambda: k_flash.flash_attention(
            q, k, v, route="simt", **kw), reps=3, inner=3)
        log(f"phase 12 flash_attention {label} ({route}): {k_ms * 1e3:.2f} "
            f"us on the device ({temp}), bound {bnd * 1e3:.2f} us by {by} "
            f"({spec['flops'] / 1e9:.2f} GFLOP, {spec['nbytes'] / 1e6:.2f} "
            f"MB; {spec['flops'] / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s, "
            f"{spec['nbytes'] / (k_ms * 1e-3) / 1e12:.3f} TB/s); simt route "
            f"{simt_ms * 1e3:.2f} us; plain {p_ms * 1e3:.1f} us; library "
            + ("null" if l_ms is None else f"{l_ms * 1e3:.2f} us")
            + f" ({what})")
        if label in ("prefill global", "decode ring"):
            routes[route] = dict(source=FLASH_SOURCES[route], shape=label,
                                 ms=k_ms, bound_ms=bnd, library_ms=l_ms)
    # simt's served call: the float32 prefill of phase 11
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(1, SERVE_PROMPT, 8, 256, generator=g, device=dev)
    k = torch.randn(1, SERVE_PROMPT, 4, 256, generator=g, device=dev)
    v = torch.randn(1, SERVE_PROMPT, 4, 256, generator=g, device=dev)
    kw = dict(causal=True, window=None, softcap=50.0, q_offset=0, kv_len=None)
    spec = kernel_spec("flash_attention", (q, k, v, kw), dev)
    bnd, by = bound_ms(spec["nbytes"], spec["flops"], spec["rate"])
    k_ms = cuda_ms(spec["kfn"], reps=3, inner=3)
    prep, call, what = flex_library((q, k, v, kw), dev)
    l_ms = None
    if prep is not None:
        args_ = prep(q, k, v)
        l_ms = cuda_ms(lambda: call(*args_), reps=3, inner=3)
    log(f"phase 12 flash_attention float32 prefill global B 1 (simt): "
        f"{k_ms * 1e3:.2f} us on the device, bound {bnd * 1e3:.2f} us by {by}"
        "; library " + ("null" if l_ms is None else f"{l_ms * 1e3:.2f} us")
        + f" ({what}; TF32 "
        + ("on" if torch.backends.cuda.matmul.allow_tf32 else "off") + ")")
    routes["simt"] = dict(source=FLASH_SOURCES["simt"],
                          shape="float32 prefill global, B 1", ms=k_ms,
                          bound_ms=bnd, library_ms=l_ms)
    k_flash.launches = saved[0]
    k_flash.launches_sm90, k_flash.launches_split, k_flash.launches_simt = (
        saved[1]["sm90"], saved[1]["split"], saved[1]["simt"])
    return routes


def kept_pairs(sq: int, kv_len: int, causal: bool, window, q_offset: int) -> int:
    """(query, key) pairs that the masks keep, for one (batch, head)."""
    i = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(kv_len, i + 1) if causal else np.full(sq, kv_len)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_cost(args_) -> tuple[float, float]:
    """(bytes, operations) of one flash-attention call: q, the kv_len valid
    rows of k and v, and o, each once; 4 hd operations a kept pair."""
    q, k, v, kw = args_
    b, sq, h, hd = q.shape
    kv_len = k.shape[1] if kw["kv_len"] is None else kw["kv_len"]
    el = q.element_size()
    nbytes = el * (2 * q.numel() + 2 * b * kv_len * k.shape[2] * hd)
    pairs = kept_pairs(sq, kv_len, kw["causal"], kw["window"],
                       kw["q_offset"])
    return nbytes, 4.0 * hd * pairs * b * h


def flex_library(args_, dev):
    """The flash yardstick for one call's masks, never called by the port:
    torch.nn.attention's flex_attention under torch.compile, with the
    softcap as a score_mod and the masks (causal, window, q_offset, kv_len)
    as a block mask; where it does not compile (a decode's single query
    row), the bf16 composite softmax(cap tanh(q k^T scale / cap)) v over
    the kv_len valid keys.  Returns (prep, call, what): prep(q, k, v) gives
    call's arguments (layout changes, outside any timing), and call(...)
    the output in flex's layout; what names the yardstick and its max
    |diff| against the plain version.  (None, None, reason) if neither
    runs."""
    import torch
    from repro_torch.kernels import ref
    q, k, v, kw = args_
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    cap, window, causal = kw["softcap"], kw["window"], kw["causal"]
    qo = kw["q_offset"]
    kvl = skv if kw["kv_len"] is None else kw["kv_len"]
    want = ref.mha_ref(q, k, v, causal=causal, window=window, softcap=cap,
                       q_offset=qo, kv_valid_len=kw["kv_len"])

    def diff(out):
        return (out.transpose(1, 2).float() - want.float()).abs().max().item()

    why = None
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def score_mod(score, b_, h_, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)

        def mask_mod(b_, h_, q_idx, kv_idx):
            keep = kv_idx < kvl
            if causal:
                keep = keep & (kv_idx <= q_idx + qo)
            if window:
                keep = keep & (kv_idx > q_idx + qo - window)
            return keep

        mask = create_block_mask(mask_mod, None, None, sq, skv, device=dev)
        fa = torch.compile(flex_attention)

        def prep(q_, k_, v_):
            return tuple(t.transpose(1, 2).contiguous() for t in (q_, k_, v_))

        def call(qt, kt, vt):
            return fa(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                      enable_gqa=True)
        err = diff(call(*prep(q, k, v)))
        return prep, call, f"flex_attention under torch.compile, max |diff| "\
            f"{err:.3g}"
    except Exception as e:      # a yardstick that does not run is reported
        why = f"flex_attention: {type(e).__name__}: {str(e)[:200]}"
    if causal or window or sq != 1:
        return None, None, why
    g = h // hkv
    scale = 1.0 / hd ** 0.5

    def prep(q_, k_, v_):
        return (q_.reshape(b, hkv, g, hd), k_[:, :kvl].permute(0, 2, 3, 1),
                v_[:, :kvl].permute(0, 2, 1, 3))

    def call(qg, kt, vt):
        x = (qg @ kt) * scale
        x = cap * torch.tanh(x / cap)
        return (torch.softmax(x.float(), dim=-1).to(qg.dtype) @ vt).reshape(
            b, h, 1, hd)
    err = diff(call(*prep(q, k, v)))
    return prep, call, f"composite softmax(cap tanh(q k^T scale / cap)) v in "\
        f"bf16 (flex did not compile: {why}), max |diff| {err:.3g}"


# ---------------------------------------------------------- phases 10-11 --

def cast_tree(tree: dict, dtype) -> dict:
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def serve_profile(fn, label: str, parts: dict, phase: int) -> None:
    """Device time by kernel of fn() from torch.profiler's CUDA activity,
    and the share of each part: `parts` maps a label to the substrings of
    the CUDA kernel names that make it up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
    except RuntimeError as e:       # no CUPTI tracing on this machine
        log(f"phase {phase} {label} device time by kernel: not measured "
            f"({e})")
        return
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    total = sum(t for _, t, _ in rows)
    shares = []
    for part, names in parts.items():
        t = sum(t for k, t, _ in rows if any(n in k for n in names))
        shares.append(f"{part} {t / 1e3:.1f} ms "
                      f"({100 * t / max(total, 1e-9):.1f}%)")
    log(f"phase {phase} {label} device time {total / 1e3:.1f} ms, of which "
        + ", ".join(shares) + ", torch.profiler; top: "
        + "; ".join(f"{k[:50]} {t / 1e3:.1f} ms x{n}" for k, t, n in rows[:8]))


def wkv_sequential_inplace(r, k, v, w, u, state, *, chunk: int):
    """`ops.wkv`'s contract through the sequential plain recurrence
    (`ref.wkv_ref`): a second plain version of the WKV, for the bf16
    noise yardstick of the rwkv6-3b serve."""
    from repro_torch.kernels import ref
    out, s = ref.wkv_ref(r, k, v, w, u, state)
    state.copy_(s)
    return out.to(r.dtype)


# Each served arch: its kernel, the `ops` function that reaches it, that
# function's plain version, a second plain version (the bf16 noise
# yardstick, or None), and the phases of its bf16 and float32 runs.
SERVED = {"gemma2-2b": ("flash_attention", "mha", "mha_ref", None,
                        (10, 11)),
          "rwkv6-3b": ("rwkv6_scan", "wkv", "wkv_inplace_ref",
                       wkv_sequential_inplace, (13, 14))}
# The CUDA kernels of each arch's kernel module, by the substrings of
# their names in a profile: flash attention's three routes, the WKV's two.
PROFILE_PARTS = {
    "gemma2-2b": {"flash sm90": ("flash_sm90_kernel",),
                  "flash split": ("flash_decode_kernel",
                                  "flash_decode_combine"),
                  "flash simt": ("flash_attention_kernel",)},
    "rwkv6-3b": {"wkv chunked": ("rwkv6_chunked_kernel",),
                 "wkv recurrent": ("rwkv6_scan_kernel",)}}
# The routes a served bf16 run must take, in launches a layer: gemma2-2b
# every prefill layer on sm90, every decode call on split; rwkv6-3b every
# prefill layer on chunked, every decode call on recurrent.  Each arch's
# float32 prefill takes the last route named.
SERVE_ROUTES = {"gemma2-2b": {"sm90": 1, "split": SERVE_GEN - 1, "simt": 0},
                "rwkv6-3b": {"chunked": 1, "recurrent": SERVE_GEN - 1}}
SERVE_F32_ROUTE = {"gemma2-2b": "simt", "rwkv6-3b": "recurrent"}


def serve_phase(dev, seed: int, card: str, arch: str) -> dict:
    """`arch` at full width through the port's serve driver, then the same
    weights with the kernel's `ops` function replaced by its plain version:
    the kernel's prefill and teacher-forced decode logits against the plain
    run's, and a float32 prefill of batch 1 held tighter."""
    import dataclasses
    from unittest import mock
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import host_time, serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import LM, init_params

    kname, op, plain_name, second, (ph, ph32) = SERVED[arch]
    plain = getattr(ref, plain_name)
    cfg = serve.serve_config(arch)
    b, p, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    t0 = time.perf_counter()
    model = init_params(cfg, seed=seed, device=dev)
    sync(dev)
    log(f"phase {ph} {arch}: {model.num_params() / 1e6:.1f}M parameters "
        f"({cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.dtype}) "
        f"initialized on the card in {time.perf_counter() - t0:.2f} s")
    prompts = torch.as_tensor(serve.make_prompts(cfg, b, p, seed),
                              device=dev)
    serve.generate(model, prompts[:, :128], 2)      # warm up

    ops.reset_launch_counts()
    run = serve.generate(model, prompts, g)
    counts = ops.launch_counts()
    want = cfg.num_layers * g
    if counts[kname] != want or \
            any(n for k, n in counts.items() if k != kname):
        fail(f"serve {arch}: launches {counts}, want {kname} = "
             f"{cfg.num_layers} + {cfg.num_layers} x {g - 1} = {want}")
    kmod = ops.KERNELS[kname]
    got_routes = kmod.route_counts()
    want_r = {r: cfg.num_layers * n for r, n in SERVE_ROUTES[arch].items()}
    on_prefill, on_decode = list(SERVE_ROUTES[arch])[:2]
    if got_routes != want_r:
        fail(f"serve {arch}: {kname} routes {got_routes}, want {want_r} "
             f"(every prefill layer on {on_prefill}, every decode call on "
             f"{on_decode})")
    routes = (f" (routes {got_routes}: prefill on {on_prefill}, decode on "
              f"{on_decode})")
    toks = run["tokens"]
    if tuple(toks.shape) != (b, g) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        fail(f"serve {arch}: tokens of shape {tuple(toks.shape)} or out of "
             "range")
    prefill_tps = b * p / run["prefill_s"]
    decode_tps = b * (g - 1) / run["decode_s"]
    log(f"phase {ph} serve {arch} B {b} prompt {p} gen {g}: prefill "
        f"{run['prefill_s']:.3f} s ({prefill_tps:.1f} tokens/s), decode "
        f"{g - 1} steps in {run['decode_s']:.3f} s ({decode_tps:.1f} "
        f"tokens/s, {1e3 * run['decode_s'] / (g - 1):.2f} ms a step), "
        f"{kname} launches {counts[kname]} = "
        f"{cfg.num_layers} + {cfg.num_layers} x {g - 1}{routes}; card {card}")
    if kname == "flash_attention":
        ht = host_time.measure(model, prompts, reps=10)
        log(f"phase {ph} {arch} decode step: {ht['step_host_ms']:.2f} ms of "
            f"host time (every launch queued) of {ht['step_wall_ms']:.2f} ms "
            f"wall, median of 10 steps; ops.mha {ht['mha_ring_host_us']:.1f} "
            f"us of host time a call on the ring, "
            f"{ht['mha_global_host_us']:.1f} on the global cache "
            f"({cfg.num_layers // 2} calls of each a step; "
            "repro_torch/launch/host_time.py)")

    prefill = make_prefill_step(cfg, s_max=p + g)
    decode = make_decode_step(cfg)
    ops.reset_launch_counts()
    with mock.patch.object(ops, op, plain):
        lg, cache = prefill(model, prompts)
        plain_logits, plain_toks = [lg], [lg[:, -1].argmax(-1)[:, None]]
        for i in range(g - 1):
            lg, cache = decode(model, cache, plain_toks[-1], p + i)
            plain_logits.append(lg)
            plain_toks.append(lg[:, -1].argmax(-1)[:, None])
    del cache
    if ops.launch_counts()[kname]:
        fail(f"serve {arch}: the plain run launched the kernel")

    def forced_errs():
        """Prefill and the g - 1 teacher-forced decode steps against the
        plain run's logits."""
        lg, cache = prefill(model, prompts)
        errs = [rel_err(lg, plain_logits[0])]
        for i in range(g - 1):
            lg, cache = decode(model, cache, plain_toks[i], p + i)
            errs.append(rel_err(lg, plain_logits[i + 1]))
        return errs, lg, cache

    tol, noise = SERVE_RTOL, ""
    if second is not None:
        with mock.patch.object(ops, op, second):
            n_errs, _, _ = forced_errs()
        tol = max(SERVE_RTOL, NOISE_FACTOR * max(n_errs))
        noise = (f"; the second plain version ({second.__name__}) against "
                 f"the first: prefill {n_errs[0]:.3g}, decode "
                 f"{max(n_errs[1:]):.3g}, so the gate is "
                 f"max({SERVE_RTOL}, {NOISE_FACTOR} x {max(n_errs):.3g})")
    errs, lg, cache = forced_errs()
    finite = all(bool(torch.isfinite(x).all()) for x in plain_logits + [lg])
    if not finite or not max(errs) <= tol:
        fail(f"serve {arch}: kernel against plain logits, max |diff| / "
             f"max|logits| prefill {errs[0]:.3g}, decode {max(errs[1:]):.3g}"
             f" > {tol:.3g} (or not finite){noise}")
    agree = float((toks == torch.cat(plain_toks, 1)).float().mean())
    log(f"phase {ph} serve {arch}: kernel against the plain {op} run on the "
        f"same weights, max |diff| / max|logits| (max|logits| "
        f"{float(plain_logits[0].abs().max()):.3g}): prefill {errs[0]:.3g}, "
        f"decode (teacher-forced, {g - 1} steps) {max(errs[1:]):.3g} <= "
        f"{tol:.3g}{noise}; the greedy run's tokens equal the plain run's "
        f"at {100 * agree:.1f}% of positions: PASS")
    serve_profile(lambda: (prefill(model, prompts), sync(dev)),
                  f"prefill (B {b}, S {p})", PROFILE_PARTS[arch], ph)
    serve_profile(lambda: ([decode(model, cache, plain_toks[i], p + i)
                            for i in range(g - 4, g - 1)], sync(dev)),
                  "3 decode steps", PROFILE_PARTS[arch], ph)
    del cache

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = LM(cfg32, cast_tree(model.tree(), torch.float32))
    del model
    prefill32 = make_prefill_step(cfg32, s_max=p)
    ops.reset_launch_counts()
    lk, _ = prefill32(model32, prompts[:1])
    if ops.launch_counts()[kname] != cfg.num_layers:
        fail(f"serve {arch} float32: the prefill did not launch the kernel "
             "once a layer")
    f32_route = SERVE_F32_ROUTE[arch]
    if kmod.route_counts()[f32_route] != cfg.num_layers:
        fail(f"serve {arch} float32: routes {kmod.route_counts()}, want "
             f"{f32_route} {cfg.num_layers} (float32 prefill stays on the "
             "CUDA cores)")
    with mock.patch.object(ops, op, plain):
        lp, _ = prefill32(model32, prompts[:1])
    e32 = rel_err(lk, lp)
    if not e32 <= SERVE_F32_RTOL or not bool(torch.isfinite(lk).all()):
        fail(f"serve {arch} float32: kernel against plain prefill logits "
             f"{e32:.3g} > {SERVE_F32_RTOL} of max|logits|")
    log(f"phase {ph32} serve {arch} float32 prefill (B 1, S {p}, TF32 off): "
        f"kernel against plain within {e32:.3g} of max|logits| <= "
        f"{SERVE_F32_RTOL}: PASS")
    del model32
    torch.cuda.empty_cache()
    return dict(counts=counts, routes=got_routes, prefill_tps=prefill_tps,
                decode_tps=decode_tps, errs=errs, e32=e32, tol=tol)


# ------------------------------------------------------------- phases 4-6 --

def make_problem(seed: int, dev, d: int = D, t: int = T, n: int = N_ROWS):
    """Seeded lstsq/nuclear problem: Y = X W* + noise with a rank-4 W*
    (`launch.amtl_sharded.make_problem`, which phase 21's ranks call)."""
    from repro_torch.launch.amtl_sharded import make_problem as build
    return build(seed, dev, d, t, n, LAM, TAU)


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
    """(busy seconds, top kernels, device operations) of the device work of
    one run, from torch.profiler's CUDA activity: the sum of kernel and
    copy times on the card while `apply_plan` runs (the host plan is made
    beforehand), and the number of kernels and copies it ran."""
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
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    rows = sorted(((e.key, e.self_device_time_total) for e in device),
                  key=lambda r: -r[1])
    return (sum(t for _, t in rows) * 1e-6, rows[:8],
            sum(e.count for e in device))


def objective(problem, cfg, v) -> float:
    from repro_torch.core.operators import backward
    return float(problem.objective(backward(problem, v, cfg.eta)))


def compare_states(label: str, card, cpu) -> float:
    """Host fields bitwise, tensors to SESSION_RTOL of their scale (the
    dense state: its ring; it has no task ring)."""
    import numpy as np
    dense = "ring" in card._fields
    for f in ("key",) if dense else ("task_ring", "key"):
        if not np.array_equal(getattr(card, f), getattr(cpu, f)):
            fail(f"{label}: {f} differs between the card and the CPU")
    if (card.ptr, card.event) != (cpu.ptr, cpu.event):
        fail(f"{label}: ptr/event differ between the card and the CPU")
    if not (np.array_equal(card.history.buf, cpu.history.buf)
            and np.array_equal(card.history.count, cpu.history.count)):
        fail(f"{label}: delay history differs between the card and the CPU")
    worst = 0.0
    for f in ("ring",) if dense else ("v", "delta_ring"):
        a = getattr(card, f).cpu().double()
        b = getattr(cpu, f).double()
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
        if not rel <= SESSION_RTOL:
            fail(f"{label}: {f} max |card - cpu| / max|cpu| = {rel:.3g} > "
                 f"{SESSION_RTOL}")
    return worst


# ------------------------------------------------------------ phases 7-8 --

def make_store(seed: int, t: int = T, d: int = D):
    """Ragged lstsq/nuclear cohorts of rng.integers(80, 400) rows drawn from
    `seed`, rows N(0, 1/d), labels x w*_t + noise with a rank-4 W*, padded
    by a TaskStore (`launch.amtl_sharded.make_store`, which phase 21's
    ranks call).  Returns the store and a maker of further labelled rows
    of task t (the feedback the store takes between chunks)."""
    from repro_torch.launch.amtl_sharded import make_store as build
    return build(seed, t, d, COHORT_LO, COHORT_HI, LAM)


def append_below_capacity(store, rows, k: int, seed: int) -> np.ndarray:
    """Append k labelled rows to tasks with room left, so the capacity does
    not double; returns the task ids in arrival order."""
    rng = np.random.default_rng(seed + 3)
    room = store.capacity - store.row_counts
    ids = []
    for _ in range(k):
        t = int(rng.choice(np.flatnonzero(room > 0)))
        room[t] -= 1
        ids.append(t)
    feats, labels = zip(*(rows(t, 1) for t in ids))
    store.append(ids, np.concatenate(feats), np.concatenate(labels))
    return np.asarray(ids)


def sgd_configs(t: int = T):
    """The ragged SGD sessions' batch and delta configs (hospitals_async.py:
    batch_size 32, dynamic step)."""
    batch_cfg, delta_cfg = configs(t)
    return (batch_cfg._replace(batch_size=SGD_BATCH, dynamic_step=True),
            delta_cfg._replace(batch_size=SGD_BATCH, dynamic_step=True))


def ragged_batch_session(store, rows, cfg, v0, key, offs, seed, dev) -> dict:
    """make_engine -> init -> run (half) -> store append -> make_engine on
    the new problem -> run (half) -> iterate, with the launch counts of
    exactly those two runs, and the host plan against the device work of
    the second chunk (with and without the minibatch cutoffs)."""
    from repro_torch.core import amtl, make_engine
    from repro_torch.kernels import ops
    problem = store.problem(dev)
    engine = make_engine(problem, cfg, device=dev)
    state0 = engine.init(v0, key)
    engine.run(state0, offs, engine.events_per_step * 2)      # warm up
    sync(dev)
    half = BATCH_EVENTS // 2

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    mid = engine.run(state0, offs, half)
    sync(dev)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    old_counts = store.row_counts
    ids = append_below_capacity(store, rows, APPEND_ROWS, seed)
    problem2 = store.problem(dev)
    engine2 = make_engine(problem2, cfg, device=dev)
    sync(dev)
    append_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = engine2.run(mid, offs, half)
    v = engine2.iterate(state)
    sync(dev)
    wall += time.perf_counter() - t0
    counts = ops.launch_counts()

    new_counts = store.row_counts
    if store.capacity != problem.xs.shape[1] \
            or (new_counts - old_counts).sum() != APPEND_ROWS:
        fail("ragged batch session: the append doubled the capacity or lost "
             "rows")
    t0 = time.perf_counter()
    plan = amtl.plan_events(problem2, cfg, mid, offs, half)
    host = time.perf_counter() - t0
    if not np.array_equal(plan.scalars[:, 3], new_counts[plan.tasks]) \
            or not np.isin(plan.tasks, ids).any():
        fail("ragged batch session: the chunk after the append does not "
             "draw its minibatches over the new row counts")
    t0 = time.perf_counter()
    amtl.plan_events(problem2, cfg._replace(batch_size=None), mid, offs,
                     half)
    host_full = time.perf_counter() - t0
    t0 = time.perf_counter()
    amtl.apply_plan(problem2, cfg, mid, plan)
    sync(dev)
    device_side = time.perf_counter() - t0
    return dict(state=state, v=v, counts=counts, wall=wall, host=host,
                host_full=host_full, device=device_side, append=append_s,
                problem=problem2, problem0=problem, plan_events=half,
                grown=len(set(ids.tolist())))


def store_gradients(problem, w, dev) -> tuple[dict, float]:
    """The ragged store's masked full gradient of every task three ways:
    `ops.lstsq_grad` one task at a time with its host row count (the
    reference's store contract, tests/test_taskstore.py:246), one
    `ops.lstsq_grad_batch` over the 128 tasks and `full_grad`, the last two
    reading the counts on the card.  All three must agree bitwise and lie
    within GRAD_RTOL of the plain version on the card; returns the launch
    counts of those calls and the worst error ratio."""
    import torch
    from repro_torch.kernels import ops, ref
    counts = problem.host_row_counts()
    tasks = torch.arange(problem.num_tasks, dtype=torch.int32, device=dev)
    w_rows = w.T.contiguous()
    ops.reset_launch_counts()
    g = torch.stack([ops.lstsq_grad(problem.xs[t], w[:, t].contiguous(),
                                    problem.ys[t], int(counts[t]))
                     for t in range(problem.num_tasks)], dim=1)
    batch = ops.lstsq_grad_batch(problem.xs, problem.ys, tasks, w_rows,
                                 problem.row_counts)
    full = problem.full_grad(w)
    launches = ops.launch_counts()
    if not (torch.equal(bits(batch.T), bits(g))
            and torch.equal(bits(full), bits(g))):
        fail("store gradients: the batched launch, full_grad and the "
             "per-task launches differ")
    want = ref.lstsq_grad_batch_ref(problem.xs, problem.ys, tasks, w_rows,
                                    problem.row_counts).T
    worst = 0.0
    for t in range(problem.num_tasks):
        xk = problem.xs[t, :int(counts[t])].double()
        res = xk @ w[:, t].double() - problem.ys[t, :int(counts[t])].double()
        scale = 2.0 * (xk.abs().T @ res.abs())
        err = (g[:, t].double() - want[:, t].double()).abs()
        worst = max(worst, float((err / scale.clamp_min(1e-30)).max()))
    if not worst <= GRAD_RTOL:
        fail(f"store gradients: ops.lstsq_grad differs from its plain "
             f"version by {worst:.3g} > {GRAD_RTOL} of 2 |X|^T |r|")
    return launches, worst


def report_session(label: str, r: dict, n: int, n_split: int,
                   phase: int = 9) -> None:
    """Events/s of the run of n events, and the host plan against the
    device work of n_split events (the same run re-split, or one chunk)."""
    log(f"phase {phase} {label}: {n / r['wall']:.1f} events/s end to end "
        f"({n} events in {r['wall']:.3f} s); host plan of {n_split} events "
        f"{r['host']:.3f} s ({n_split / r['host']:.1f} events/s), device "
        f"work {r['device']:.3f} s ({n_split / r['device']:.1f} events/s)")


def report_busy(label: str, problem, cfg, v0, key, offs, n, device_s,
                dev, phase: int = 9) -> None:
    try:
        busy, top, n_ops = device_profile(problem, cfg, v0, key, offs, n,
                                          dev)
    except RuntimeError as e:       # no CUPTI tracing on this machine
        log(f"phase {phase} {label} device busy share: not measured ({e})")
        return
    log(f"phase {phase} {label} device busy {busy:.4f} s of the {device_s:.3f} s "
        f"device-work window ({100 * busy / device_s:.1f}%), {n_ops / n:.2f} "
        "kernels and copies an event, torch.profiler; top: "
        + "; ".join(f"{k[:60]} {t / 1e3:.1f} ms" for k, t in top))


def kernel_spec(name: str, args_, dev) -> dict:
    """Bytes, operations, the kernel, its plain version and the library
    call for one kernel at its main-path shape."""
    import itertools
    import torch
    from repro_torch.kernels import ops, ref
    kern = ops.KERNELS[name.split()[0]]
    if name == "amtl_event":
        # the engine form: V's column t and ring[slot] in place
        v, t, p, g, eta, eta_k, ring, slot = args_
        d = v.shape[0]
        # three reads (the column, p, g) and two writes (column, undo) of d
        nbytes, flops = 5 * 4 * d, 4 * d
        vk, rk, vp, rp = v.clone(), ring.clone(), v.clone(), ring.clone()
        kfn = lambda: kern.amtl_event_inplace(vk, t, p, g, eta, eta_k, rk,
                                              slot)
        pfn = lambda: ref.amtl_event_inplace_ref(vp, t, p, g, eta, eta_k, rp,
                                                 slot)
        lib = None
        src, rep = "amtl_event.cu", "src/repro/kernels/amtl_event.py:69"
    elif name == "amtl_event contiguous":
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
    elif name == "svt_reconstruct":
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
    elif name == "lstsq_grad_sampled":
        xs, ys, ts, w_rows, scal, b = args_
        nbytes, flops, kept, scale2 = sampled_cost(args_, dev)
        kfn = lambda: kern.lstsq_grad_sampled_batch(*args_)
        pfn = lambda: ref.lstsq_grad_sampled_batch_ref(*args_)
        # each event's kept rows gathered from the flat buffer (the keep
        # bits taken as given), then two batched products
        kmax = max(int(k.numel()) for k in kept)
        n = xs.shape[1]
        idx = torch.zeros((len(kept), kmax), dtype=torch.int64, device=dev)
        mask = torch.zeros((len(kept), kmax), device=dev)
        for e, k in enumerate(kept):
            idx[e, :k.numel()] = int(ts[e]) * n + k
            mask[e, :k.numel()] = 1.0
        flat_x, flat_y = xs.view(-1, xs.shape[2]), ys.view(-1)
        s2 = torch.tensor(scale2, device=dev)

        def lib():
            xk = flat_x.index_select(0, idx.view(-1)).view(*idx.shape, -1)
            r = (torch.bmm(xk, w_rows[:, :, None])[..., 0]
                 - flat_y.index_select(0, idx.view(-1)).view(idx.shape)) * mask
            return s2[:, None] * torch.bmm(xk.transpose(1, 2),
                                           r[:, :, None])[..., 0]
        src = "lstsq_grad_sampled.cu"
        rep = "src/repro/kernels/lstsq_grad_sampled.py:131"
    elif name == "sample_mask":
        # the engine form: the kept rows of x and zeros for the others
        x, block = args_
        n, d = x.shape
        keep = ref.keep_bits_ref(n, block, x.device)
        # the kept rows read, every row written
        nbytes, flops = 4 * d * (n + int(keep.sum())), 0
        kfn = lambda: kern.sample_rows(x, block)
        pfn = lambda: ref.sample_rows_ref(x, block)
        lib = lambda: torch.where(keep[:, None], x, 0.0)
        src = "lstsq_grad_sampled.cu"
        rep = "src/repro/kernels/lstsq_grad_sampled.py:165"
    elif name == "sample_mask bits":
        n, block, mdev = args_
        nbytes, flops = n, 0
        kfn = lambda: kern.sample_mask(n, block, mdev)
        pfn = lambda: ref.keep_bits_ref(n, block, mdev)
        lib = None
        src = "lstsq_grad_sampled.cu"
        rep = "src/repro/kernels/lstsq_grad_sampled.py:165"
    elif name == "flash_attention":
        q, k, v, kw = args_
        nbytes, flops = flash_cost(args_)
        kfn = lambda: kern.flash_attention(q, k, v, **kw)
        pfn = lambda: ref.mha_ref(
            q, k, v, causal=kw["causal"], window=kw["window"],
            softcap=kw["softcap"], q_offset=kw["q_offset"],
            kv_valid_len=kw["kv_len"])
        lib = None                  # flex_library, timed by the caller
        src = "flash_attention_sm90.cu"     # the route of the main shape
        rep = "src/repro/kernels/flash_attention.py:96"
    elif name == "rwkv6_scan":
        r, k, v, w, u, s0 = args_
        route = kern.route(r.dtype, *r.shape)
        nbytes, ops_ = wkv_cost(args_, route)
        flops, wkv_rate = ops_[0]
        s_k, s_p, s_l = s0.clone(), s0.clone(), s0.clone()
        kfn = lambda: kern.wkv(r, k, v, w, u, s_k)
        plain = ref.wkv_subchunk_ref if route == "chunked" else ref.wkv_ref
        pfn = lambda: plain(r, k, v, w, u, s_p)
        lib = lambda: ref.wkv_chunked_ref(r, k, v, w, u, WKV_CHUNK, s_l)
        src = WKV_SOURCES[route].rsplit("/", 1)[1]
        rep = "src/repro/kernels/rwkv6_scan.py:64"
    elif name == "l21_prox":
        w, t = args_
        d, tt = w.shape
        # a read and a write an element; a square-add and a scale an
        # element, a root, a division and a subtraction a row
        nbytes, flops = 2 * w.element_size() * w.numel(), 3 * d * tt + 3 * d
        kfn = lambda: kern.l21_prox(w, t)
        pfn = lambda: ref.l21_prox_ref(w, t)
        lib = lambda: w * torch.clamp(1.0 - t / torch.clamp(
            torch.linalg.vector_norm(w, dim=1, keepdim=True), min=1e-12),
            min=0.0)
        src, rep = "l21_prox.cu", "src/repro/kernels/l21_prox.py:45"
    elif name == "km_update":
        # the engine form: ring[dst] = ring[src] with column t updated
        ring, s_src, s_dst, t, p, g, eta, eta_k = args_
        _, d, tt = ring.shape
        # a slot read and one written (src == dst: the column), p and g
        # read; two fmas and a subtraction a row
        nbytes = 4 * (2 * d * tt + 2 * d) if s_src != s_dst else 16 * d
        flops = 3 * d
        rk, rp, rl = ring.clone(), ring.clone(), ring.clone()
        kfn = lambda: kern.km_update_slot(rk, s_src, s_dst, t, p, g, eta,
                                          eta_k)
        pfn = lambda: ref.km_update_slot_ref(rp, s_src, s_dst, t, p, g, eta,
                                             eta_k)
        lib = lambda: rl[s_dst].copy_(rl[s_src])
        src, rep = "km_update.cu", "src/repro/kernels/km_update.py:55"
    elif name == "km_update contiguous":
        v, p, g, eta, eta_k = args_
        # three reads and a write an element; two fmas an element
        nbytes, flops = 4 * v.element_size() * v.numel(), 4 * v.numel()
        kfn = lambda: kern.km_update(v, p, g, eta, eta_k)
        pfn = lambda: ref.km_update_ref(v, p, g, eta, eta_k)
        lib = lambda: v + eta_k * (p - eta * g - v)
        src, rep = "km_update.cu", "src/repro/kernels/km_update.py:55"
    else:
        # a batch step's B events, each call the next of disjoint steps
        # whose X (268 MB each at 32 x 256 x 8192) overflows the L2
        xs, ys, steps, w_rows = args_
        nbytes, flops = grad_cost(xs, steps[0], w_rows, None)
        walk, lib_walk = itertools.cycle(steps), itertools.cycle(steps)
        kfn = lambda: kern.lstsq_grad_batch(xs, ys, next(walk), w_rows)
        pfn = lambda: ref.lstsq_grad_batch_ref(xs, ys, steps[0], w_rows)
        wcol = w_rows[:, :, None]

        def lib():
            idx = next(lib_walk).long()
            xk = xs.index_select(0, idx)
            r = torch.bmm(xk, wcol) - ys.index_select(0, idx)[:, :, None]
            return 2 * torch.bmm(xk.transpose(1, 2), r)[..., 0]
        src, rep = "lstsq_grad.cu", "src/repro/kernels/lstsq_grad.py:104"
    rate = BF16_FLOP_PER_S if name == "flash_attention" \
        and args_[0].dtype == torch.bfloat16 else FP32_FLOP_PER_S
    if name == "rwkv6_scan":
        rate = wkv_rate
    return dict(kern=kern, nbytes=nbytes, flops=flops, kfn=kfn, pfn=pfn,
                lib=lib, src=src, rep=rep, rate=rate)


def grad_cost(xs, tasks, w_rows, row_counts) -> tuple[float, float]:
    """(bytes, operations) of B full gradients: the valid rows of X and y of
    each task the batch names read once, w read and G written, the task ids
    (and row counts) read; 4 n_t d operations an event."""
    import torch
    from repro_torch.kernels import ref
    num_t, n, d = xs.shape
    picked = [ref.task_index(int(t), num_t) for t in tasks.tolist()]
    counts = [n] * num_t if row_counts is None else row_counts.tolist()
    nbytes = sum(4 * (counts[t] * d + counts[t]) for t in set(picked))
    nbytes += 4 * (2 * len(picked) * d + len(picked)) \
        + (0 if row_counts is None else 4 * num_t)
    return nbytes, sum(4 * counts[t] * d for t in picked)


def grad_inputs(dev, seed: int) -> tuple:
    """Phase 12's inputs of the full gradient at the batch cell's widths: X
    (128, 256, 8192), 1.07 GB, y, four disjoint steps of 32 tasks (268 MB
    of X each) and a step's 32 points."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    xs = torch.randn(T, N_ROWS, D, generator=g, device=dev) / D ** 0.5
    ys = torch.randn(T, N_ROWS, generator=g, device=dev)
    perm = torch.randperm(T, generator=g, device=dev).to(torch.int32)
    steps = [perm[i:i + BATCH].contiguous() for i in range(0, T, BATCH)]
    return xs, ys, steps, torch.randn(BATCH, D, generator=g, device=dev)


def grad_times(args_, dev) -> dict:
    """The full gradient at B 1 (L2-cold: each call on the next of the 128
    tasks, 8.4 MB each; and L2-warm, one task again) beside the composite
    2 * (x.T @ (x @ w - y)) on the same walk, and at B 128 (FISTA's full
    gradient, every task in one launch) beside two bmm."""
    import itertools
    import torch
    from repro_torch.kernels import ops
    kern = ops.KERNELS["lstsq_grad"]
    saved = kern.launches
    xs, ys, steps, w_rows = args_
    w = w_rows[0].contiguous()
    cyc, lib_cyc = itertools.cycle(range(T)), itertools.cycle(range(T))

    def composite(t):
        x = xs[t]
        return 2 * (x.T @ (x @ w - ys[t]))
    every = torch.arange(T, dtype=torch.int32, device=dev)
    w_all = torch.randn(T, D, device=dev)
    wcol = w_all[:, :, None]
    out = dict(
        b1_l2_cold_ms=cuda_ms(lambda: kern.lstsq_grad_task(xs, ys, next(cyc),
                                                           w)),
        b1_l2_warm_ms=cuda_ms(lambda: kern.lstsq_grad_task(xs, ys, 3, w)),
        b1_bound_ms=bound_ms(*grad_cost(xs, every[:1], w_rows[:1], None))[0],
        b1_library_l2_cold_ms=cuda_ms(lambda: composite(next(lib_cyc))),
        all_tasks_ms=cuda_ms(lambda: kern.lstsq_grad_batch(xs, ys, every,
                                                           w_all), reps=11),
        all_tasks_bound_ms=bound_ms(*grad_cost(xs, every, w_all, None))[0],
        all_tasks_library_ms=cuda_ms(lambda: 2 * torch.bmm(
            xs.transpose(1, 2), torch.bmm(xs, wcol) - ys[:, :, None]),
            reps=11))
    kern.launches = saved           # timing launches are not the path's
    log(f"phase 12 lstsq_grad B 1 (n 256, d 8192): L2-cold "
        f"{out['b1_l2_cold_ms'] * 1e3:.2f} us, L2-warm "
        f"{out['b1_l2_warm_ms'] * 1e3:.2f} us (bound "
        f"{out['b1_bound_ms'] * 1e3:.2f} us), the composite 2 * (x.T @ (x @ "
        f"w - y)) L2-cold {out['b1_library_l2_cold_ms'] * 1e3:.2f} us; B 128 "
        f"(every task, FISTA's full gradient) {out['all_tasks_ms'] * 1e3:.2f}"
        f" us (bound {out['all_tasks_bound_ms'] * 1e3:.2f} us), two bmm "
        f"{out['all_tasks_library_ms'] * 1e3:.2f} us")
    return out


def mask_bits_times(info: dict, dev) -> dict:
    """The standalone keep bits (sample_mask's own entry point) beside its
    engine form."""
    spec = kernel_spec("sample_mask bits", info["sample_mask bits"]["args"],
                       dev)
    saved = spec["kern"].launches
    out = dict(bits_ms=cuda_ms(spec["kfn"]),
               bits_bound_ms=bound_ms(spec["nbytes"], spec["flops"])[0])
    spec["kern"].launches = saved
    log(f"phase 12 sample_mask bits alone (n 400): {out['bits_ms'] * 1e3:.2f}"
        f" us (bound {out['bits_bound_ms'] * 1e3:.5f} us)")
    return out


def sampled_cost(args_, dev) -> tuple:
    """(bytes, operations, kept rows, scale2) of a batch of minibatch
    gradients: each event's kept rows of X and their y read once, its w
    read and its G written, its (B, 4) block read; 4 k d operations an
    event of k kept rows (the products and the sums)."""
    import torch
    from repro_torch.kernels import ref
    xs, ys, ts, w_rows, scal, b = args_
    d = xs.shape[2]
    host = scal.cpu().numpy()
    kept = [torch.nonzero(ref.keep_bits_ref(xs.shape[1], host[e], dev))[:, 0]
            for e in range(host.shape[0])]
    ks = [int(k.numel()) for k in kept]
    nbytes = sum(4 * (k * d + k + 2 * d) + 16 for k in ks) + 4 * len(ks)
    scale2 = [2 * float(np.float32(h[3]) / np.float32(max(min(b, int(h[3])),
                                                          1)))
              for h in host]
    return nbytes, sum(4 * k * d for k in ks), kept, scale2


def batch_layout_floor(args_) -> float:
    """The bytes amtl_event_batch must move in V's row-major (d, T) layout:
    every 32-byte sector of a row that holds a touched column read and
    written, besides p, g and undo, in ms at the card's memory rate."""
    import torch
    v, p, g, ts, eta, eks = args_
    d, num_t = v.shape
    cols = torch.unique(ts[(ts >= 0) & (ts < num_t)]).long()
    rows = torch.arange(d, device=v.device)[:, None]
    sectors = torch.unique(((rows * num_t + cols[None, :]) * 4) // 32).numel()
    nbytes = 2 * 32 * sectors + 4 * (3 * d * p.shape[1] + 2 * p.shape[1])
    return nbytes / HBM_BYTES_PER_S * 1e3


LIBRARY_CALLS = {
    "gauss_sketch": "torch.matmul against a stored Omega",
    "svt_reconstruct": "(qu * s) @ vt",
    "lstsq_grad_sampled": "composite: each event's kept rows by "
                          "index_select, then two torch.bmm, for the B "
                          "events of a batch step",
    "lstsq_grad": "composite: xs.index_select(0, tasks), then two "
                  "torch.bmm, for the 32 events of a batch step",
    "sample_mask": "torch.where(keep[:, None], x, 0.0), the keep bits given",
    "flash_attention": "flex_attention under torch.compile, softcap as "
                       "score_mod, the masks as a block mask",
    "rwkv6_scan": "composite: the log-space chunked form wkv_chunked_ref "
                  "(einsums and a loop over 128-token chunks); no one "
                  "PyTorch call computes the recurrence",
    "l21_prox": "composite: w * clamp(1 - t / clamp(vector_norm(w, dim=1), "
                "1e-12), 0), float32; no one PyTorch call computes the prox",
    "km_update": "ring[dst].copy_(ring[src]): the slot copy alone, one "
                 "PyTorch call that does less work",
    "km_update contiguous": "composite: v + eta_k * (p - eta*g - v), four "
                            "elementwise ops; no one PyTorch call computes "
                            "the update",
}


def sampled_single_times(info: dict, dev) -> dict:
    """The minibatch gradient kernel at B = 1 (one event of the main batch,
    and the single-event case of phase 3), beside the batched launch."""
    from repro_torch.kernels import ops
    kern = ops.KERNELS["lstsq_grad_sampled"]
    xs, ys, ts, w_rows, scal, b = info["args"]
    one = (xs, ys, ts[:1], w_rows[:1], scal[:1], b)
    x, w, y, block, b1 = info["single"]["args"]
    saved = kern.launches
    one_ms = cuda_ms(lambda: kern.lstsq_grad_sampled_batch(*one))
    single_ms = cuda_ms(lambda: kern.lstsq_grad_sampled(x, w, y, block, b1))
    kern.launches = saved
    nbytes, flops, _, _ = sampled_cost(one, dev)
    bnd, _ = bound_ms(nbytes, flops)
    log(f"phase 12 lstsq_grad_sampled B = 1: {one_ms * 1e3:.2f} us on the "
        f"device for event 0 of the main batch (bound {bnd * 1e3:.2f} us), "
        f"{single_ms * 1e3:.2f} us for phase 3's single event (240 of 399 "
        "rows, d 8192) through the single-event call")
    return dict(b1_ms=one_ms, b1_bound_ms=bnd, single_event_ms=single_ms)


def event_batch_times(args_, ms: float) -> dict:
    """amtl_event_batch's layout floor, beside its time."""
    floor = batch_layout_floor(args_)
    log(f"phase 12 amtl_event_batch {ms * 1e3:.2f} us; layout floor "
        f"{floor * 1e3:.2f} us (every 32-byte sector of V holding a touched "
        f"column read and written)")
    return dict(layout_floor_ms=floor)


def engine_form_times(name: str, info: dict, dev) -> dict:
    """The engine form of amtl_event or km_update beside its yardsticks:
    L2-cold, the parent tree's four-launch composite on the same state
    (L2-warm and L2-cold), and the contiguous call of earlier slices.

    amtl_event's cold walk takes COLD_INPUTS iterates (52 MB) in turn, and
    column t stepped a 32-byte sector at a time, so each call meets
    sectors untouched for 208 calls.  km_update's takes two (9, 8192, 128)
    rings (75 MB) in turn, slot pairs (0, 1), (2, 3), ..., (8, 0), (1, 2),
    ... on each, so a slot comes back after at least 8 calls (64 MB)."""
    import itertools
    import torch
    from repro_torch.kernels import ops
    kern = ops.KERNELS[name]
    saved = kern.launches
    if name == "amtl_event":
        v, t, p, g, eta, eta_k, ring, slot = info[name]["args"]
        d, tt = v.shape
        states = [(v.clone(), ring.clone()) for _ in range(COLD_INPUTS)]
        walk = [(st, c) for c in range(t % 8, tt, 8) for st in states]
        warm = ((v.clone(), ring.clone()), t)

        def engine(x):
            (vv, rr), c = x
            kern.amtl_event_inplace(vv, c, p, g, eta, eta_k, rr, slot)

        def parent(x):
            (vv, rr), c = x
            v_new, old = kern.amtl_event(vv[:, c].contiguous(), p, g, eta,
                                         eta_k)
            vv[:, c] = v_new
            rr[slot] = old
        library = None
        # each word of the column in a 32-byte sector of its own, read and
        # written; p and g read, the undo entry written
        floor_bytes = 2 * 32 * d + 3 * 4 * d
        contiguous = kernel_spec("amtl_event contiguous",
                                 info["amtl_event contiguous"]["args"], dev)
    else:
        ring, src, dst, t, p, g, eta, eta_k = info[name]["args"]
        depth = ring.shape[0]
        rings = [ring.clone(), ring.clone()]
        starts = [(2 * j) % depth for j in range(depth)]    # 0, 2, .., 7
        walk = [(rr, a, (a + 1) % depth) for a in starts for rr in rings]
        warm = (ring.clone(), src, dst)

        def engine(x):
            rr, a, b = x
            kern.km_update_slot(rr, a, b, t, p, g, eta, eta_k)

        def parent(x):
            rr, a, b = x
            cur = rr[a]
            v_t = kern.km_update(cur[:, t].contiguous(), p, g, eta, eta_k)
            rr[b] = cur
            rr[b, :, t] = v_t

        def library(x):
            rr, a, b = x
            rr[b].copy_(rr[a])
        floor_bytes = None
        contiguous = kernel_spec("km_update contiguous",
                                 info["km_update column"]["args"], dev)
    cold = [itertools.cycle(walk) for _ in range(3)]
    out = dict(l2_cold_ms=cuda_ms(lambda: engine(next(cold[0]))),
               parent_composite_ms=cuda_ms(lambda: parent(warm)),
               parent_composite_l2_cold_ms=cuda_ms(
                   lambda: parent(next(cold[1]))),
               contiguous_ms=cuda_ms(contiguous["kfn"]),
               contiguous_bound_ms=bound_ms(contiguous["nbytes"],
                                            contiguous["flops"])[0])
    if library is not None:
        out["library_l2_cold_ms"] = cuda_ms(lambda: library(next(cold[2])))
    if floor_bytes is not None:
        out["layout_floor_ms"] = floor_bytes / HBM_BYTES_PER_S * 1e3
    torch.cuda.synchronize()
    kern.launches = saved           # timing launches are not the path's
    log(f"phase 12 {name} engine form: L2-cold {out['l2_cold_ms'] * 1e3:.2f}"
        " us"
        + (f" (library {out['library_l2_cold_ms'] * 1e3:.2f} us)"
           if library is not None else "")
        + f"; the parent's four-launch composite "
        f"{out['parent_composite_ms'] * 1e3:.2f} us L2-warm, "
        f"{out['parent_composite_l2_cold_ms'] * 1e3:.2f} us L2-cold; the "
        f"contiguous call {out['contiguous_ms'] * 1e3:.2f} us (bound "
        f"{out['contiguous_bound_ms'] * 1e3:.2f} us)"
        + (f"; layout floor {out['layout_floor_ms'] * 1e3:.2f} us"
           if floor_bytes is not None else ""))
    return out


# L2-cold timing of the prox's two kernels: each call takes the next of
# COLD_INPUTS distinct main-shape inputs (13 x 4 MB > the H100's 50 MB L2),
# as the batch cell's refreshes each meet a new iterate.
COLD_INPUTS = 13


def sketch_recon_cold(name: str, args_, dev) -> dict:
    """L2-cold device time of gauss_sketch or svt_reconstruct and of its
    library call at the main shape, and the kernel's launch plan.  Each
    call walks COLD_INPUTS distinct inputs in turn; svt_reconstruct's calls
    also write distinct outputs (the last COLD_INPUTS are kept alive, so
    the allocator hands each call a buffer written 13 calls before)."""
    import collections
    import itertools
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import gauss_sketch as k_sketch
    from repro_torch.kernels import svt_reconstruct as k_recon
    if name == "gauss_sketch":
        w, seed, off, p = args_
        ws = [w] + [torch.randn_like(w) for _ in range(COLD_INPUTS - 1)]
        omega = ref.gauss_omega_ref(w.shape[1], p, seed, off, dev)
        ring, lib_ring = itertools.cycle(ws), itertools.cycle(ws)
        kfn = lambda: k_sketch.gauss_sketch(next(ring), seed, off, p)
        lfn = lambda: torch.matmul(next(lib_ring), omega)
        pl = dict(k_sketch.plan(*w.shape, p, _build.sm_count(dev))._asdict(),
                  cols=k_sketch.COLS)
    else:
        qu, s, vt = args_
        qus = [qu] + [torch.randn_like(qu) for _ in range(COLD_INPUTS - 1)]
        ring, lib_ring = itertools.cycle(qus), itertools.cycle(qus)
        outs = collections.deque(maxlen=COLD_INPUTS)
        kfn = lambda: outs.append(k_recon.svt_reconstruct(next(ring), s, vt))
        lfn = lambda: outs.append((next(lib_ring) * s) @ vt)
        pl = dict(k_recon.plan(*qu.shape, vt.shape[1],
                               _build.sm_count(dev))._asdict(),
                  cols=k_recon.COL_TILE)
    saved = k_sketch.launches, k_recon.launches
    cold = dict(l2_cold_ms=cuda_ms(kfn), library_l2_cold_ms=cuda_ms(lfn),
                plan=dict(pl, threads=256))
    k_sketch.launches, k_recon.launches = saved  # not the path's launches
    return cold


# The profiler's device timestamps can lag its host clock by hundreds of
# microseconds, so the parts are told apart on the device's own timeline:
# each part runs as one burst, PART_GAP_S after the last.
PART_GAP_S = 0.05


def profile_parts(parts: dict, inputs: list) -> dict:
    """{part: (device ms a call, device events a call)} from one
    torch.profiler session in which each part makes one pass over
    `inputs`, ended by a synchronize and PART_GAP_S of idle device.  The
    device events (kernels, copies) fall into one burst a part, split at
    the idle gaps; fails unless there is exactly one burst a part."""
    import time
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PART_GAP_S)
        for fn in parts.values():
            for x in inputs:
                fn(x)
            torch.cuda.synchronize()
            time.sleep(PART_GAP_S)
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    bursts = []
    for e in evs:
        if not bursts or e.time_range.start - bursts[-1][-1].time_range.end \
                > PART_GAP_S * 1e6 / 5:
            bursts.append([])
        bursts[-1].append(e)
    if len(bursts) != len(parts):
        fail(f"prox refresh: the profiler recorded {len(bursts)} bursts of "
             f"device events, want one for each of the {len(parts)} parts")
    return {name: (sum(e.time_range.elapsed_us() for e in b)
                   / len(inputs) / 1e3, len(b) / len(inputs))
            for name, b in zip(parts, bursts)}


def prox_refresh_breakdown(dev, seed: int) -> dict:
    """One randomized-SVT refresh (`prox.svt_randomized`) at the batch
    cell's shape (d 8192, T 128, rank 16, p 24), L2-cold: each call takes
    the next of COLD_INPUTS distinct iterates.  For the whole refresh and
    each of its parts: the stream time a call (CUDA events behind the
    device sleep, as the kernels are timed: the device time of a part that
    does not synchronize the host; one that does pays its host time there
    too), the parts that synchronize the host, from
    torch.cuda.set_sync_debug_mode("warn") around one call of each, and
    the device time a call from torch.profiler (`profile_parts`)."""
    import itertools
    import warnings
    import torch
    from repro_torch.core import prng, prox
    from repro_torch.kernels import ops
    from repro_torch.kernels import gauss_sketch as k_sketch
    from repro_torch.kernels import svt_reconstruct as k_recon
    saved = k_sketch.launches, k_recon.launches
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    key = prng.key_from_seed(seed)
    sd = prox._sketch_seed(key)
    p = prox.sketch_width(RANK, D, T)
    thresh = ETA * LAM
    inputs = []
    for _ in range(COLD_INPUTS):
        w = torch.randn(D, T, generator=g, device=dev)
        y = ops.gauss_sketch(w, sd, 0, p)
        q, _ = torch.linalg.qr(y)
        b = q.T @ w
        ub, sv, vt = torch.linalg.svd(b, full_matrices=False)
        sv = torch.clamp(sv - thresh, min=0.0).contiguous()
        inputs.append(dict(w=w, y=y, q=q, b=b, ub=ub, s=sv,
                           vt=vt.contiguous(), qub=(q @ ub).contiguous()))
    parts = {
        "refresh": lambda x: prox.svt_randomized(x["w"], thresh, rank=RANK,
                                                 key=key),
        "gauss_sketch": lambda x: ops.gauss_sketch(x["w"], sd, 0, p),
        "qr": lambda x: torch.linalg.qr(x["y"]),
        "q.T @ w": lambda x: x["q"].T @ x["w"],
        "svd (24, 128)": lambda x: torch.linalg.svd(x["b"],
                                                    full_matrices=False),
        "q @ ub": lambda x: x["q"] @ x["ub"],
        "svt_reconstruct": lambda x: ops.svt_reconstruct(x["qub"], x["s"],
                                                         x["vt"]),
    }
    out = {}
    for name, fn in parts.items():
        ring = itertools.cycle(inputs)
        stream_ms = cuda_ms(lambda: fn(next(ring)), reps=11)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn(inputs[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(c.message) for c in caught)
        out[name] = dict(stream_ms=stream_ms, host_syncs=syncs)

    for name, (device_ms, events) in profile_parts(parts, inputs).items():
        out[name].update(device_ms=device_ms, device_events=events)
    k_sketch.launches, k_recon.launches = saved
    return out


def expect_launches(label: str, counts: dict, want: dict) -> None:
    """Fail unless each kernel launched exactly want.get(kernel, 0) times."""
    if any(n != want.get(k, 0) for k, n in counts.items()):
        fail(f"{label}: launches {counts}, want {want} and no other kernel")


def l21_km_times(info: dict) -> None:
    """Device time, bound, plain and composite time of the two kernels at
    the kernels bench's shapes (the path's shapes are in the table)."""
    for key, name, shape in (("km_update block", "km_update contiguous",
                              "(8192, 128)"),
                             ("l21_prox bench", "l21_prox", "(8192, 64)")):
        spec = kernel_spec(name, info[key]["args"], None)
        saved = spec["kern"].launches
        k_ms = cuda_ms(spec["kfn"])
        p_ms = cuda_ms(spec["pfn"], inner=1, backlog=False)
        l_ms = cuda_ms(spec["lib"])
        spec["kern"].launches = saved
        bnd, by = bound_ms(spec["nbytes"], spec["flops"], spec["rate"])
        log(f"phase 12 {name} {shape} float32: {k_ms * 1e3:.2f} us on the "
            f"device, bound {bnd * 1e3:.2f} us by {by} "
            f"({spec['nbytes'] / 1e6:.2f} MB), plain {p_ms * 1e3:.1f} us, "
            f"library {l_ms * 1e3:.2f} us ({LIBRARY_CALLS[name]})")


def l21_configs():
    """The dense engine, its delta twin (prox_every 1) and the batch
    engine (event_batch 32, prox_every 32), at the engine cells' steps."""
    from repro_torch.core import AMTLConfig
    from repro_torch.core.operators import amtl_max_step
    base = AMTLConfig(eta=ETA, eta_k=amtl_max_step(TAU, T, 0.9), tau=TAU)
    return (base._replace(engine="dense"), base._replace(engine="delta"),
            base._replace(engine="batch", event_batch=BATCH,
                          prox_every=BATCH))


def l21_phases(problem, problem_cpu, v0, key, offs, dev) -> dict:
    """Phases 15-19: the dense engine (l2,1 and nuclear with its exact
    SVD), dense == delta bitwise on the card, the batch engine on the l2,1
    formulation, the card against the port's CPU run, and FISTA's
    reference optimum.  Returns the dense l2,1 session's launch counts."""
    import torch
    from repro_torch.core import (current_iterate, fista_solve,
                                  reference_optimum)
    from repro_torch.core.operators import backward
    from repro_torch.kernels import ops
    l21p = problem._replace(reg_name="l21")
    dense_cfg, delta_cfg, batch_cfg = l21_configs()
    n, nn = DENSE_L21_EVENTS, DENSE_NUCLEAR_EVENTS

    # phase 15: dense sessions at full width
    obj0 = objective(l21p, dense_cfg, v0)
    dn = run_session(l21p, dense_cfg, v0, key, offs, n, dev)
    expect_launches("dense l21 session", dn["counts"],
                    {"km_update": n, "l21_prox": n, "lstsq_grad": n})
    ops.reset_launch_counts()
    obj1 = objective(l21p, dense_cfg, dn["v"])
    metric = ops.launch_counts()["l21_prox"]
    if tuple(dn["v"].shape) != (D, T) or not bool(
            torch.isfinite(dn["v"]).all()) or not obj1 < obj0 or metric != 1:
        fail(f"dense l21 session: iterate not finite, objective {obj0} -> "
             f"{obj1} did not fall, or the metric's prox launched {metric} "
             "times")
    log(f"phase 15 dense l21 session: {n} events, launches {dn['counts']} "
        f"(one km_update, one l21_prox and one lstsq_grad an event, no "
        f"amtl_event), plus "
        f"{metric} l21_prox for the objective, {obj0:.6g} -> {obj1:.6g}: PASS")
    report_session("dense l21", dn, n, n, phase=15)
    report_busy("dense l21", l21p, dense_cfg, v0, key, offs, n, dn["device"],
                dev, phase=15)
    dnn = run_session(problem, dense_cfg, v0, key, offs, nn, dev)
    expect_launches("dense nuclear session", dnn["counts"],
                    {"km_update": nn, "lstsq_grad": nn})
    obj_n = objective(problem, dense_cfg, dnn["v"])
    if not bool(torch.isfinite(dnn["v"]).all()) \
            or not obj_n < objective(problem, dense_cfg, v0):
        fail("dense nuclear session: iterate not finite or objective did not "
             "fall")
    log(f"phase 15 dense nuclear session (exact SVD each event): {nn} events, "
        f"launches {dnn['counts']}, objective {obj_n:.6g}: PASS")
    report_session("dense nuclear", dnn, nn, nn, phase=15)
    report_busy("dense nuclear", problem, dense_cfg, v0, key, offs, nn,
                dnn["device"], dev, phase=15)

    # phase 16: dense == delta, bitwise, on the card
    dl = run_session(l21p, delta_cfg, v0, key, offs, n, dev)
    expect_launches("delta l21 session", dl["counts"],
                    {"amtl_event": n, "l21_prox": n, "lstsq_grad": n})
    ds, ls = dn["state"], dl["state"]
    if not (torch.equal(bits(current_iterate(ds)), bits(ls.v))
            and (ds.ptr, ds.event) == (ls.ptr, ls.event)
            and np.array_equal(ds.key, ls.key)
            and np.array_equal(ds.history.buf, ls.history.buf)):
        fail("dense and delta l21 sessions differ on the card at prox_every 1 "
             f"(max |diff| {(current_iterate(ds) - ls.v).abs().max().item()})")
    log(f"phase 16 dense == delta (l21, prox_every 1, {n} events, the same "
        f"key and delay offsets): iterates bitwise equal on the card; delta "
        f"launches {dl['counts']}: PASS")
    report_session("delta l21", dl, n, n, phase=16)
    report_busy("delta l21", l21p, delta_cfg, v0, key, offs, n, dl["device"],
                dev, phase=16)

    # phase 17: the batch engine on the l2,1 formulation
    nb = BATCH_EVENTS
    bl = run_session(l21p, batch_cfg, v0, key, offs, nb, dev)
    expect_launches("batch l21 session", bl["counts"],
                    {"amtl_event_batch": nb // BATCH, "l21_prox": nb // BATCH,
                     "lstsq_grad": nb // BATCH})
    w = backward(l21p, bl["v"], ETA)
    zeroed = float((w == 0).all(dim=1).float().mean())
    obj_b = float(l21p.objective(w))
    if not bool(torch.isfinite(w).all()) or not obj_b < obj0:
        fail(f"batch l21 session: prox(V) not finite or objective {obj0} -> "
             f"{obj_b} did not fall")
    log(f"phase 17 batch l21 session: {nb} events, launches {bl['counts']} "
        f"(no gauss_sketch), objective {obj0:.6g} -> {obj_b:.6g}, "
        f"{100 * zeroed:.2f}% of the rows of prox(V) zeroed by the threshold "
        f"{ETA * LAM:g}: PASS")
    report_session("batch l21", bl, nb, nb, phase=17)
    report_busy("batch l21", l21p, batch_cfg, v0, key, offs, nb,
                bl["device"], dev, phase=17)

    # phase 18: the card against the port's CPU run of the same state
    cpu = torch.device("cpu")
    l21_cpu = problem_cpu._replace(reg_name="l21")
    worst = {}
    for label, cfg in (("dense l21", dense_cfg), ("batch l21", batch_cfg)):
        card_s = run_session(l21p, cfg, v0, key, offs, CPU_EVENTS,
                             dev)["state"]
        cpu_s = run_session(l21_cpu, cfg, v0.cpu(), key, offs, CPU_EVENTS,
                            cpu)["state"]
        worst[label] = compare_states(label, card_s, cpu_s)
    log(f"phase 18 l21 card vs CPU ({CPU_EVENTS} events): event streams "
        f"bitwise, max relative |diff| of the ring/v/delta_ring {worst} <= "
        f"{SESSION_RTOL}: PASS")

    # phase 19: FISTA's optimum, the quality anchor of the l21 sessions
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, obj_star = reference_optimum(l21p, eta=ETA, num_iters=FISTA_ITERS,
                                    device=dev)
    obj_star = float(obj_star)
    secs = time.perf_counter() - t0
    fista_counts = ops.launch_counts()
    expect_launches("reference_optimum", fista_counts,
                    {"l21_prox": FISTA_ITERS, "lstsq_grad": FISTA_ITERS})
    if not np.isfinite(obj_star) or not obj_star < obj0:
        fail(f"reference_optimum: objective {obj_star} not finite or not "
             f"below the start's {obj0}")
    z = torch.zeros((D, T), device=dev)
    card_f = fista_solve(l21p, z, ETA, FISTA_CPU_ITERS, device=dev)
    cpu_f = fista_solve(l21_cpu, z.cpu(), ETA, FISTA_CPU_ITERS, device=cpu)
    rel = float(((card_f.objectives.cpu().double()
                  - cpu_f.objectives.double()).abs()
                 / cpu_f.objectives.double().abs()).max())
    if not rel <= FISTA_RTOL:
        fail(f"fista_solve: card objectives {rel:.3g} relative from the "
             f"CPU's > {FISTA_RTOL}")
    log(f"phase 19 reference_optimum (FISTA, l21, {FISTA_ITERS} iterations "
        f"from zero, eta {ETA}): objective {obj_star:.6g} in {secs:.3f} s "
        f"({fista_counts['l21_prox']} l21_prox and "
        f"{fista_counts['lstsq_grad']} lstsq_grad launches); gap of the "
        f"batch l21 session {obj_b - obj_star:.6g} "
        f"({100 * (obj_b - obj_star) / abs(obj_star):.3f}%), of the dense "
        f"l21 session {obj1 - obj_star:.6g}; {FISTA_CPU_ITERS} iterations on "
        f"the card and the CPU: objectives within {rel:.3g} <= {FISTA_RTOL} "
        "relative: PASS")
    t0 = time.perf_counter()
    fista_solve(l21p, z, ETA, FISTA_CPU_ITERS, device=dev)
    sync(dev)
    log(f"phase 19 FISTA: {FISTA_CPU_ITERS} iterations in "
        f"{time.perf_counter() - t0:.3f} s of wall time, profiled next")
    serve_profile(lambda: (fista_solve(l21p, z, ETA, FISTA_CPU_ITERS,
                                       device=dev), sync(dev)),
                  f"FISTA ({FISTA_CPU_ITERS} iterations)",
                  {"the l21_prox kernel": ("l21_",),
                   "the lstsq_grad kernel": ("lstsq_grad_kernel",)}, 19)
    return dn["counts"]


# ---------------------------------------------------------------- phase 20 --

def serve_traffic(rows, seed: int) -> list:
    """SERVE_BATCHES request batches: (prediction task ids, features,
    feedback task ids, features, labels), the feedback rows drawn by the
    store's `rows` (the same cohorts' w*)."""
    rng = np.random.default_rng(seed + 4)
    out = []
    for _ in range(SERVE_BATCHES):
        qt = rng.integers(0, T, SERVE_ROWS)
        qx = rng.standard_normal((SERVE_ROWS, D), dtype=np.float32) \
            / np.float32(D ** 0.5)
        ft = rng.integers(0, T, SERVE_ROWS)
        fx, fy = zip(*(rows(int(t), 1) for t in ft))
        out.append((qt, qx, ft, np.concatenate(fx), np.concatenate(fy)))
    return out


def record_boundaries(server) -> list:
    """Wrap the server's chunk boundary: after each committed chunk, log
    (the store's row counts, or None before the first fold, and the
    chunk's events).  The wrapper is an instance attribute, so the
    learner thread and `step()` both go through it."""
    out = []
    real = server._step_once

    def step_once():
        before = len(server.chunk_log)
        n = real()
        if len(server.chunk_log) > before:
            store = server._store
            out.append((None if store is None else store.row_counts, n))
        return n

    server._step_once = step_once
    return out


def time_folds(server, dev) -> list:
    """Wrap the server's fold: the seconds of each boundary that folded
    rows, its upload finished on the server's stream."""
    import torch
    out = []
    real = server._fold_pending_rows

    def fold():
        t0 = time.perf_counter()
        undo = real()
        if undo is not None:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            out.append(time.perf_counter() - t0)
        return undo

    server._fold_pending_rows = fold
    return out


def time_checkpoints(server) -> list:
    """Wrap `checkpoint()`: (seconds, engine record path, event) a call."""
    out = []
    real = server.checkpoint

    def ckpt():
        t0 = time.perf_counter()
        path = real()
        out.append((time.perf_counter() - t0, path, server.event_count))
        return path

    server.checkpoint = ckpt
    return out


def replay_boundaries(base, final, cfg, v0, key, boundaries, dev):
    """One engine session over a server's committed chunks: before each,
    the store grown to that boundary's row counts (each task's rows, in
    order, from the server's final store `final`), the problem and engine
    rebuilt, then `engine.run` of the chunk's events."""
    from repro_torch.core import make_engine
    from repro_torch.data import TaskStore
    store = TaskStore(*base, "lstsq", "nuclear", LAM)
    counts = store.row_counts
    fx, fy = final.state()[:2]
    engine = make_engine(store.problem(dev), cfg, device=dev)
    state = engine.init(v0, key)
    for want, n in boundaries:
        if want is not None and (want != counts).any():
            ids = np.repeat(np.arange(T), want - counts)
            at = np.concatenate([np.arange(c, w) for c, w in
                                 zip(counts, want)])
            store.append(ids, fx[ids, at], fy[ids, at])
            counts = want
            engine = make_engine(store.problem(dev), cfg, device=dev)
        state = engine.run(state, None, n)
    return state


def states_equal(a, b) -> bool:
    from repro_torch.interop import state_to_numpy
    return all(np.array_equal(x, y) for x, y in
               zip(state_to_numpy(a), state_to_numpy(b), strict=True))


def stores_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in
               zip(a.state(), b.state(), strict=True))


def wait_for(label: str, predicate) -> None:
    deadline = time.perf_counter() + SERVE_WAIT_S
    while not predicate():
        if time.perf_counter() > deadline:
            fail(f"{label}: not reached within {SERVE_WAIT_S} s")
        time.sleep(0.005)


def record_bytes(ckpt_dir: Path, path: str, event: int) -> int:
    store = ckpt_dir / "store" / f"step_{event:08d}.npz"
    return os.path.getsize(path) + (os.path.getsize(store)
                                    if store.exists() else 0)


def amtl_serve_phase(dev, seed: int, card: str) -> dict:
    """Phase 20: the learn-while-serve AMTLServer at the engine cells'
    width: cooperative serving with a checkpoint and a resume, threaded
    learning, chaos under a FaultPlan, the card against the port's CPU
    server, and the exact launches of the path's four kernels."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.core import prng
    from repro_torch.data import TaskStore
    from repro_torch.kernels import ops
    from repro_torch.serve import (AMTLServer, FaultPlan, InjectedFault,
                                   ServeConfig)
    t_phase = time.perf_counter()
    ckpt_dir = ROOT / "build" / "serve_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    free = shutil.disk_usage(ckpt_dir).free
    if free < SERVE_FREE_BYTES:
        fail(f"serve phase: {free / 1e9:.1f} GB free under {ckpt_dir}, the "
             f"checkpoints need {SERVE_FREE_BYTES / 1e9:.0f} GB")
    store0, rows = make_store(seed)
    base = store0.state()
    traffic = serve_traffic(rows, seed)
    problem = store0.problem(dev)
    cfg = configs()[0]
    v0 = (np.float32(0.01) * np.random.default_rng(seed + 5).standard_normal(
        (D, T), dtype=np.float32))
    key = prng.key_from_seed(seed)
    sc = ServeConfig(**SERVE_CFG, ckpt_dir=str(ckpt_dir))
    expected = TaskStore(*base, "lstsq", "nuclear", LAM)
    for _, _, ft, fx, fy in traffic:
        expected.append(ft, fx, fy)
    sync(dev)
    ops.reset_launch_counts()
    card_events = 0

    # 1. cooperative serving, the checkpoint at 2048 events, a resume
    a = AMTLServer(problem, cfg, v0, key, sc, device=dev)
    bounds_a = record_boundaries(a)
    folds = time_folds(a, dev)
    ckpts = time_checkpoints(a)
    preds_a, lat_learn = [], []
    appends = 0
    resume_s, first = 0.0, None
    t0 = time.perf_counter()
    for i, (qt, qx, ft, fx, fy) in enumerate(traffic):
        tb = time.perf_counter()
        preds_a.append(a.predict(qt, qx))        # waits: slo_ms is set
        lat_learn.append(1e3 * (time.perf_counter() - tb))
        receipt = a.submit_feedback(ft, fx, fy)
        if receipt.rejected:
            fail(f"serve: batch {i} feedback rejected ({receipt!r})")
        appends += receipt.accepted
        a.step()
        if i == 0:
            first = (a._state, list(a.chunk_log))
        if i == SERVE_RESUME_AT - 1:
            tr = time.perf_counter()
            b = AMTLServer.resume(problem, cfg, v0, key, sc, device=dev)
            resume_s = time.perf_counter() - tr
    learn_wall = time.perf_counter() - t0
    ckpt_s = sum(c[0] for c in ckpts)
    learn_s = learn_wall - resume_s - ckpt_s
    at, total = SERVE_RESUME_AT * SERVE_ROWS, SERVE_BATCHES * SERVE_ROWS
    if [c[2] for c in ckpts] != [at, total] or a.event_count != total:
        fail(f"serve: checkpoints at {[c[2] for c in ckpts]}, "
             f"{a.event_count} events; want [{at}, {total}] and {total}")
    if b.event_count != at or len(b.chunk_log) != 0:
        fail(f"serve: resume at event {b.event_count}, want {at}")
    bounds_b = record_boundaries(b)
    for i in range(SERVE_RESUME_AT, SERVE_BATCHES):
        qt, qx, ft, fx, fy = traffic[i]
        preds, _, _ = b.serve(qt, qx, ft, fx, fy)
        if not torch.equal(preds, preds_a[i]):
            fail(f"serve: the resumed server's predictions of batch {i} "
                 "differ from the uninterrupted server's")
    if b.chunk_log != a.chunk_log[-len(b.chunk_log):] \
            or not states_equal(a._state, b._state) \
            or not stores_equal(a._store, b._store):
        fail("serve: the resumed server's chunks, state or store differ "
             "from the uninterrupted server's")
    if not stores_equal(a._store, expected):
        fail("serve: the server's store is not the arrival-order appends "
             "of the accepted rows")
    verify_s = []
    for sec, path, event in ckpts:
        t1 = time.perf_counter()
        checkpoint.verify(path)
        checkpoint.verify(str(ckpt_dir / "store" / f"step_{event:08d}.npz"))
        verify_s.append(time.perf_counter() - t1)
    ckpt_bytes = [record_bytes(ckpt_dir, path, event)
                  for _, path, event in ckpts]
    t1 = time.perf_counter()
    checkpoint.checkpoint._crc(a._store._xs)        # the record's largest leaf
    crc_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    replay = replay_boundaries(base, a._store, cfg, v0, key, bounds_a, dev)
    replay_s = time.perf_counter() - t1
    if not states_equal(a._state, replay):
        fail("serve: the server's state is not the replay of its chunk log "
             "with the same folds")
    card_events += 2 * sum(a.chunk_log) + sum(b.chunk_log)
    del b, replay
    log(f"phase 20 cooperative serving: {SERVE_BATCHES} batches of "
        f"{SERVE_ROWS} predictions + {SERVE_ROWS} labelled rows, "
        f"{len(a.chunk_log)} chunks {sorted(set(a.chunk_log))} events, store "
        f"{int(base[2].sum())} -> {a.store_rows} rows, capacity "
        f"{base[0].shape[1]} -> {a._store.capacity}; resume at {at} "
        f"(batches {SERVE_RESUME_AT}..{SERVE_BATCHES - 1}) bitwise: "
        f"predictions, chunks, state, store; the state bitwise the replay "
        f"of its {len(bounds_a)} folds and chunks ({replay_s:.1f} s): PASS")
    fold_ms = [1e3 * s for s in folds]
    log(f"phase 20 fold (append, whole-store upload, engine rebuild) a "
        f"boundary: {len(folds)} boundaries, median "
        f"{statistics.median(fold_ms):.1f} ms, first {fold_ms[0]:.1f} ms "
        f"(store made from the problem), max {max(fold_ms):.1f} ms, "
        f"{sum(folds):.2f} s of the {learn_wall:.2f} s loop")
    log("phase 20 checkpoints: "
        + "; ".join(f"event {e}: {nb / 1e9:.3f} GB in {s:.2f} s "
                    f"({nb / 1e9 / s:.2f} GB/s), verify {v:.2f} s"
                    for (s, _, e), nb, v in zip(ckpts, ckpt_bytes, verify_s))
        + f"; CRC32 of the store's xs alone {crc_s:.2f} s; resume "
          f"(verify, store and engine restore, upload) {resume_s:.2f} s")

    # 2. threaded learning while the main thread predicts and submits
    c = AMTLServer(problem, cfg, v0, key,
                   sc._replace(ckpt_dir=str(ckpt_dir / "threaded")),
                   device=dev)
    bounds_c = record_boundaries(c)
    lat_thread = []
    c.start_learner()
    t0 = time.perf_counter()
    for qt, qx, ft, fx, fy in traffic:
        tb = time.perf_counter()
        c.predict(qt, qx)
        lat_thread.append(1e3 * (time.perf_counter() - tb))
        receipt = c.submit_feedback(ft, fx, fy)
        if receipt.rejected:
            fail(f"threaded serving: feedback rejected ({receipt!r})")
    thread_wall = time.perf_counter() - t0
    c.stop_learner(drain=True)
    drain_s = time.perf_counter() - t0
    if not stores_equal(c._store, expected):
        fail("threaded serving: the store is not the arrival-order appends")
    replay = replay_boundaries(base, c._store, cfg, v0, key, bounds_c, dev)
    if not states_equal(c._state, replay):
        fail("threaded serving: the state is not the replay of its chunk "
             "log with the same folds")
    card_events += 2 * sum(c.chunk_log)
    slo = c.stats()["slo"]
    log(f"phase 20 threaded serving: {len(c.chunk_log)} chunks (sizes "
        f"{min(c.chunk_log)}..{max(c.chunk_log)}), {sum(c.chunk_log)} events,"
        f" {c.pending_feedback} left below a step; serving loop "
        f"{thread_wall:.2f} s, drained at {drain_s:.2f} s; the state bitwise "
        f"the replay of its chunk log: PASS")
    del c, replay

    # frozen serving: the same predictions, nothing learned
    frozen = AMTLServer(problem, cfg, v0, key,
                        sc._replace(learning=False, ckpt_dir=None,
                                    checkpoint_every=None), device=dev)
    t0 = time.perf_counter()
    for qt, qx, _, _, _ in traffic:
        frozen.predict(qt, qx)
    frozen_wall = time.perf_counter() - t0
    del frozen

    # 3. chaos under a FaultPlan
    plan = FaultPlan(nan_feedback=[(0, 5)], crash_on_chunks={1},
                     poison_iterate_on_chunks={3}, fail_checkpoint_calls={1})
    chaos = AMTLServer(problem, cfg, v0, key,
                       sc._replace(ckpt_dir=str(ckpt_dir / "chaos"),
                                   restart_limit=2, restart_backoff_s=0.01),
                       device=dev, fault_plan=plan)
    bounds_chaos = record_boundaries(chaos)
    batches = traffic[:SERVE_CHAOS_BATCHES]
    receipt = chaos.submit_feedback(*batches[0][2:])
    if tuple(receipt) != (SERVE_ROWS - 1, 1) or receipt.reason != "nonfinite":
        fail(f"chaos: the NaN row was not rejected at admission ({receipt!r})")
    chaos.submit_feedback(*batches[1][2:])
    chaos.start_learner()
    wait_for("chaos: chunk 0", lambda: len(chaos.chunk_log) == 1)
    chaos.submit_feedback(*batches[2][2:])                  # chunk 1 crashes
    wait_for("chaos: the restart",
             lambda: chaos.stats()["health"]["learner_restarts"] == 1)
    chaos.submit_feedback(*batches[3][2:])
    chaos.stop_learner(drain=True)
    snap = chaos.serving()
    rows_before = chaos._store.state()
    chaos.submit_feedback(*batches[4][2:])
    quarantined = chaos.step()                            # chunk 3 poisoned
    if chaos.serving() is not snap or not stores_equal(
            chaos._store, TaskStore(*rows_before, "lstsq", "nuclear", LAM)):
        fail("chaos: the poisoned chunk moved the snapshot or kept its rows")
    card_events += quarantined
    chaos.submit_feedback(*batches[5][2:])
    chaos.step()
    chaos.checkpoint()                                    # call 0: the pair
    bridged = (chaos.event_count, chaos.store_rows, chaos.iterate().clone())
    chaos.submit_feedback(*batches[6][2:])
    chaos.step()
    try:
        chaos.checkpoint()                                # call 1: torn
        fail("chaos: the scripted checkpoint crash did not fire")
    except InjectedFault:
        pass
    health = chaos.stats()["health"]
    want = dict(learner_restarts=1, learner_crashes=1, nonfinite_feedback=1,
                nonfinite_chunks=1, quarantined_feedback=quarantined)
    got = {k: health[k] for k in want}
    if got != want or quarantined == 0 \
            or len(health["quarantine_log"]) != 1 \
            or sum(health["quarantine_log"][0].values()) != quarantined:
        fail(f"chaos: health {health}, want {want}")
    if not bool(torch.isfinite(chaos.iterate()).all()):
        fail("chaos: the served snapshot is not finite")
    replay = replay_boundaries(base, chaos._store, cfg, v0, key,
                               bounds_chaos, dev)
    if not states_equal(chaos._state, replay):
        fail("chaos: the state is not the replay of its surviving chunks")
    card_events += 2 * sum(chaos.chunk_log)
    t1 = time.perf_counter()
    resumed = AMTLServer.resume(problem, cfg, v0, key, chaos.serve_cfg,
                                device=dev)
    chaos_resume_s = time.perf_counter() - t1
    if (resumed.event_count, resumed.store_rows) != bridged[:2] \
            or not torch.equal(resumed.iterate(), bridged[2]) \
            or not bool(torch.isfinite(resumed.iterate()).all()):
        fail(f"chaos: resume landed on event {resumed.event_count} with "
             f"{resumed.store_rows} rows, want the bridged pair {bridged[:2]}")
    log(f"phase 20 chaos: NaN row rejected at admission, 1 learner crash "
        f"healed ({health['recovery_ms'][0]:.2f} ms), {quarantined} events "
        f"quarantined with their fold rolled back, the torn checkpoint "
        f"bridged (resume at event {resumed.event_count}, "
        f"{chaos_resume_s:.2f} s); snapshot finite, the state bitwise the "
        f"replay of its {len(chaos.chunk_log)} surviving chunks: PASS")
    del chaos, resumed, replay

    # 4. the card against the port's CPU server: the first chunk
    cpu_problem = store0.problem("cpu")
    cpu_srv = AMTLServer(cpu_problem, cfg, v0, key,
                         sc._replace(ckpt_dir=None, checkpoint_every=None),
                         device="cpu")
    qt, qx, ft, fx, fy = traffic[0]
    cpu_srv.serve(qt, qx, ft, fx, fy)
    if cpu_srv.chunk_log != first[1]:
        fail(f"card vs CPU: chunk logs {first[1]} and {cpu_srv.chunk_log}")
    worst = compare_states("serve first chunk", first[0], cpu_srv._state)
    del cpu_srv, cpu_problem

    # 5. the path's kernels, launched exactly once a batch step
    counts = ops.launch_counts()
    if card_events % BATCH:
        fail(f"serve: {card_events} events on the card, not whole steps")
    want = {k: card_events // BATCH for k in
            ("lstsq_grad", "amtl_event_batch", "gauss_sketch",
             "svt_reconstruct")}
    expect_launches("serve phase", counts, want)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_req = SERVE_BATCHES * SERVE_ROWS
    metrics = {
        "requests_per_sec_learning": n_req / learn_s,
        "requests_per_sec_threaded": n_req / thread_wall,
        "requests_per_sec_frozen": n_req / frozen_wall,
        "predict_p50_ms": float(np.percentile(lat_learn, 50)),
        "predict_p95_ms": float(np.percentile(lat_learn, 95)),
        "predict_p99_ms": float(np.percentile(lat_thread, 99)),
        "slo_violations": int(slo["violations"]),
        "events_per_sec_learning": sum(a.chunk_log) / learn_s,
        "appends_per_sec": appends / learn_s,
        "fold_ms_median": statistics.median(fold_ms),
        "fold_ms_max": max(fold_ms),
        "checkpoint_bytes": ckpt_bytes,
        "checkpoint_s": [cp[0] for cp in ckpts],
        "verify_s": verify_s,
        "crc_xs_s": crc_s,
        "resume_s": resume_s,
        "learner_restarts": int(health["learner_restarts"]),
        "quarantined_feedback": int(health["quarantined_feedback"]),
        "recovery_ms": [float(ms) for ms in health["recovery_ms"]],
        "card_vs_cpu": worst,
        "launches": want,
        "seconds": time.perf_counter() - t_phase,
    }
    log(f"phase 20 serving ({card}): requests/s while learning "
        f"{metrics['requests_per_sec_learning']:.1f} (cooperative, "
        f"checkpoint and resume seconds excluded), threaded "
        f"{metrics['requests_per_sec_threaded']:.1f}, frozen "
        f"{metrics['requests_per_sec_frozen']:.1f}; predict p50 "
        f"{metrics['predict_p50_ms']:.3f} ms, p95 "
        f"{metrics['predict_p95_ms']:.3f} ms, p99 (threaded) "
        f"{metrics['predict_p99_ms']:.3f} ms, {metrics['slo_violations']} "
        f"over the {SERVE_CFG['slo_ms']} ms SLO; events/s while learning "
        f"{metrics['events_per_sec_learning']:.1f}, appends/s "
        f"{metrics['appends_per_sec']:.1f}")
    log(f"phase 20 card vs CPU (first chunk, {first[1]} events): chunk logs "
        f"equal, max relative |diff| of v/delta_ring {worst:.3g} <= "
        f"{SESSION_RTOL}; launches {want} ({card_events} events on the "
        f"card, quarantined included) and no other kernel: PASS "
        f"({metrics['seconds']:.1f} s)")
    log("serving " + json.dumps(metrics))
    return metrics


# ---------------------------------------------------------------- phase 21 --

def shard_owned_ring_equal(leaves, batch_state) -> bool:
    """Each slot of the batch engine's undo ring equals the slot of the
    rank that owns its task (the other ranks' slots hold the undo entries
    of events they dropped)."""
    rings = leaves[1]                      # (n_shards, tau+1, d)
    n_local = T // rings.shape[0]
    want = batch_state.delta_ring.cpu().numpy()
    owner = np.asarray(batch_state.task_ring) // n_local
    return all(np.array_equal(rings[owner[j], j], want[j])
               for j in range(want.shape[0]))


def shard_stream_equal(leaves, batch_state) -> bool:
    """The host leaves (the event stream) equal the batch state's."""
    return (np.array_equal(leaves[2], batch_state.task_ring)
            and int(leaves[3]) == batch_state.ptr
            and int(leaves[4]) == batch_state.event
            and np.array_equal(leaves[6], batch_state.history.buf)
            and np.array_equal(leaves[7], batch_state.history.count)
            and np.array_equal(leaves[8], batch_state.key))


def shard_times(label: str, r: dict, cfg, card: str) -> dict:
    """Events/s, each refresh's collective seconds and bytes (against
    ProxPlan.comm_bytes_per_refresh for the distributed prox, the (d, T)
    gather for the replicated one) and rank 0's device busy share."""
    from repro_torch.core.prox import ProxPlan
    refreshes = r["events"] // cfg.prox_every
    coll = r["collectives"]
    plan = ProxPlan(T, T // SHARD_RANKS)
    want = (plan.comm_bytes_per_refresh(D, RANK)
            if cfg.prox_mode == "distributed" else D * T * 4)
    out = {"events_per_s": r["events"] / r["seconds"],
           "collective_ms_per_refresh": 1e3 * coll["seconds"] / refreshes,
           "collective_bytes_per_refresh": coll["bytes"] / refreshes,
           "model_bytes_per_refresh": want,
           "collective_calls": coll["calls"]}
    if "busy" in r:
        # the profiled rerun's busy seconds over the unprofiled run's wall
        out["rank0_busy_s"] = r["busy"]["busy_s"]
        out["rank0_busy_share"] = r["busy"]["busy_s"] / r["seconds"]
        out["rank0_device_ops_per_event"] = r["busy"]["ops"] / r["events"]
    log(f"phase {label}: {out['events_per_s']:.1f} events/s "
        f"({r['events']} events in {r['seconds']:.3f} s), collectives "
        f"{out['collective_ms_per_refresh']:.3f} ms and "
        f"{out['collective_bytes_per_refresh']:.0f} bytes a refresh "
        f"(model {want} bytes), rank 0 device busy "
        + (f"{100 * out['rank0_busy_share']:.1f}%" if "busy" in r
           else "not measured")
        + f" [{card}; {SHARD_RANKS} ranks share this card's SMs and the "
        "collectives go through host memory: not scale-out numbers]")
    return out


def shard_kernel_times(dev, seed: int) -> dict:
    """Each kernel of the sharded path at a rank's shapes (n_local 64 of T
    128, BATCH // SHARD_RANKS owned events a step), L2-warm, with its
    bound and the full-width call's time in the same window: the launch
    plans were tuned at T 128 (gauss_sketch's and svt_reconstruct's keep
    their grids at 64 columns)."""
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import amtl_event_batch as k_batch
    from repro_torch.kernels import gauss_sketch as k_sketch
    from repro_torch.kernels import lstsq_grad as k_grad
    from repro_torch.kernels import svt_reconstruct as k_recon
    g = torch.Generator(device=dev).manual_seed(seed + 29)
    n_local, owned = T // SHARD_RANKS, BATCH // SHARD_RANKS
    p = min(RANK + 8, min(D, T))
    sms = _build.sm_count(dev)
    w = torch.randn(D, T, generator=g, device=dev)
    blk = w[:, n_local:].contiguous()
    qu, vt = torch.randn(D, p, generator=g, device=dev), torch.randn(
        p, T, generator=g, device=dev)
    s = torch.rand(p, generator=g, device=dev)
    vt_loc = vt[:, n_local:].contiguous()
    tasks = torch.randint(0, T, (BATCH,), generator=g, device=dev,
                          dtype=torch.int32)
    local, _ = ref.shard_local_tasks(tasks, n_local, n_local)
    uniq = int(torch.unique(local[local < n_local]).numel())
    pc, gc = (torch.randn(D, BATCH, generator=g, device=dev)
              for _ in range(2))
    eks = torch.rand(BATCH, generator=g, device=dev)
    vb = torch.randn(D, n_local, generator=g, device=dev)
    xs = torch.randn(n_local, N_ROWS, D, generator=g, device=dev) / D ** 0.5
    ys = torch.randn(n_local, N_ROWS, generator=g, device=dev)
    ids = torch.randperm(n_local, generator=g, device=dev)[:owned].to(
        torch.int32)
    w_rows = torch.randn(owned, D, generator=g, device=dev)
    cases = {
        "gauss_sketch": (lambda: k_sketch.gauss_sketch(blk, 7, n_local, p),
                         lambda: k_sketch.gauss_sketch(w, 7, 0, p),
                         4 * (D * n_local + D * p), 2 * D * n_local * p,
                         k_sketch.plan(D, n_local, p, sms)),
        "svt_reconstruct": (lambda: k_recon.svt_reconstruct(qu, s, vt_loc),
                            lambda: k_recon.svt_reconstruct(qu, s, vt),
                            4 * (D * p + p + p * n_local + D * n_local),
                            2 * D * p * n_local + D * p,
                            k_recon.plan(D, p, n_local, sms)),
        "amtl_event_batch": (
            lambda: k_batch.amtl_event_batch(vb, pc, gc, local, ETA, eks),
            None, 4 * (2 * D * uniq + 3 * D * BATCH + 2 * BATCH),
            4 * D * BATCH, None),
        "lstsq_grad": (
            lambda: k_grad.lstsq_grad_batch(xs, ys, ids, w_rows, None),
            None, 4 * (owned * N_ROWS * (D + 1) + 2 * owned * D),
            4 * owned * N_ROWS * D, None)}
    out = {}
    for name, (kfn, full, nbytes, flops, pl) in cases.items():
        ms = cuda_ms(kfn)
        bnd, by = bound_ms(nbytes, flops)
        out[name] = dict(ms=ms, bound_ms=bnd, bound_by=by,
                         full_width_ms=None if full is None else cuda_ms(full),
                         plan=None if pl is None else pl._asdict())
        log(f"phase 21 {name} at a rank's shapes: {ms * 1e3:.2f} us (bound "
            f"{bnd * 1e3:.2f} us by {by})"
            + ("" if full is None else
               f", the full-width call {out[name]['full_width_ms'] * 1e3:.2f}"
               f" us; plan {pl}"))
    del xs, ys
    torch.cuda.empty_cache()
    return out


def sharded_phase(dev, seed: int, card: str, problem, v0, offs, key,
                  batch: dict) -> dict:
    """Phase 21: the task-sharded engine at the batch cell's width, one
    rank in this process (21a) and SHARD_RANKS ranks on this card
    (21b-21f), against the batch engine's states."""
    import torch
    from repro_torch.core import amtl
    from repro_torch.kernels import ops
    from repro_torch.launch import amtl_sharded
    from repro_torch.launch.mesh import run_world

    batch_cfg, _ = configs(T)
    repl = batch_cfg._replace(engine="sharded")
    dist_cfg = repl._replace(prox_mode="distributed")
    want = batch["state"]
    times = {}

    # 21a: one rank, both proxes: bitwise the batch state, same launches
    for label, cfg in (("replicated", repl), ("distributed", dist_cfg)):
        r = run_session(problem, cfg, v0, key, offs, BATCH_EVENTS, dev)
        st = r["state"]
        if not (bits(st.v).equal(bits(want.v))
                and bits(st.delta_ring[0]).equal(bits(want.delta_ring))
                and shard_stream_equal(
                    [None, None, st.task_ring, st.ptr, st.event, None,
                     st.history.buf, st.history.count, st.key], want)):
            fail(f"21a one rank, {label} prox: the sharded state is not "
                 "bitwise the batch state")
        for k in ("amtl_event_batch", "gauss_sketch", "svt_reconstruct",
                  "lstsq_grad", "lstsq_grad_sampled"):
            if r["counts"][k] != batch["counts"][k]:
                fail(f"21a one rank, {label} prox: {k} launched "
                     f"{r['counts'][k]} times, the batch session "
                     f"{batch['counts'][k]}")
        times[f"1 rank {label}"] = {"events_per_s": BATCH_EVENTS / r["wall"]}
        log(f"phase 21a one rank, {label} prox: {BATCH_EVENTS} events "
            f"bitwise the batch state, launches {r['counts']} (the batch "
            f"session's), {BATCH_EVENTS / r['wall']:.1f} events/s [{card}]: "
            "PASS")
    sharded_launches = dict(r["counts"])

    # the batch engine's states the two-rank parts are held to
    short = run_session(problem, batch_cfg, v0, key, offs,
                        SHARD_GATE_EVENTS, dev)["state"]
    lag = np.where(np.arange(T) < T // SHARD_RANKS, TAU, 0).astype(
        np.float32)
    lagged = run_session(problem, batch_cfg, v0, key, lag, BATCH_EVENTS,
                         dev)["state"]
    store, _ = make_store(seed, T, D)
    sgd_cfg, _ = sgd_configs(T)
    rp = store.problem(dev)
    sgd = run_session(rp, sgd_cfg, v0, key, offs, BATCH_EVENTS,
                      dev)["state"]
    del rp, store
    torch.cuda.empty_cache()

    ckpt = ROOT / "build" / "shard_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    fields = lambda c: {k: v for k, v in c._asdict().items()}  # noqa: E731
    base = dict(key=np.asarray(key), events=BATCH_EVENTS, v0="uniform",
                offsets=offs, problem="uniform")
    runs = [dict(base, cfg=fields(repl), warmup=2, profile=True),
            dict(base, cfg=fields(dist_cfg), events=SHARD_GATE_EVENTS),
            dict(base, cfg=fields(dist_cfg), profile=True),
            dict(base, cfg=fields(repl), offsets=lag),
            dict(base, cfg=fields(repl), save=(str(ckpt), BATCH_EVENTS // 2)),
            dict(base, cfg=fields(repl._replace(
                batch_size=sgd_cfg.batch_size, dynamic_step=True)),
                 problem="ragged")]
    problems = {"uniform": dict(seed=seed, d=D, t=T, n=N_ROWS, lam=LAM,
                                tau=TAU),
                "ragged": dict(store_seed=seed, d=D, t=T, lo=COHORT_LO,
                               hi=COHORT_HI, lam=LAM)}
    t0 = time.perf_counter()
    out = run_world(amtl_sharded.session, SHARD_RANKS,
                    dict(device=dev.type, problems=problems, runs=runs),
                    device=dev.type, timeout=SHARD_WORLD_TIMEOUT_S,
                    collective_timeout=SHARD_COLLECTIVE_TIMEOUT_S,
                    workdir=str(ROOT / "build"))
    world_s = time.perf_counter() - t0
    r0 = out[0]
    for i in range(len(runs)):
        if not all(np.array_equal(a, b) for a, b in
                   zip(out[0][i]["leaves"], out[1][i]["leaves"])):
            fail(f"phase 21 run {i}: the ranks' global states differ")

    # 21b: replicated prox, the gathered v and the host leaves bitwise
    lv = r0[0]["leaves"]
    if not (np.array_equal(lv[0], want.v.cpu().numpy())
            and shard_stream_equal(lv, want)
            and shard_owned_ring_equal(lv, want)):
        fail(f"21b {SHARD_RANKS} ranks, replicated prox: the gathered state "
             "is not bitwise the batch state")
    steps = BATCH_EVENTS // BATCH
    # one gradient launch a step with an event of the rank's: the task
    # stream (the same for every run here: one key, T tasks) by rank
    tasks = amtl.plan_events(problem, batch_cfg, amtl.init_batch_state(
        batch_cfg, v0, T, key), offs, BATCH_EVENTS).tasks
    owner = tasks.reshape(steps, BATCH) // (T // SHARD_RANKS)
    owned_steps = [int(np.any(owner == r, axis=1).sum())
                   for r in range(SHARD_RANKS)]
    for r in range(SHARD_RANKS):
        got = out[r][0]["launches"]
        if dev.type == "cuda" and not (
                got["amtl_event_batch"] == got["gauss_sketch"]
                == got["svt_reconstruct"] == steps
                and got["lstsq_grad"] == owned_steps[r]):
            fail(f"21b: rank {r}'s launches {got}; want {steps} of "
                 "amtl_event_batch, gauss_sketch and svt_reconstruct and "
                 f"{owned_steps[r]} of lstsq_grad (the steps with an event "
                 "of the rank's)")
    times[f"{SHARD_RANKS} ranks replicated"] = shard_times(
        f"21b {SHARD_RANKS} ranks, replicated prox", r0[0], repl, card)
    log(f"phase 21b {SHARD_RANKS} ranks (gloo), replicated prox: "
        f"{BATCH_EVENTS} events, the gathered v, the owned ring slots and "
        f"the host leaves bitwise the batch state; rank 0's launches "
        f"{r0[0]['launches']}, lstsq_grad by rank {owned_steps} (the steps "
        "with an event of the rank's): PASS")

    # 21c: distributed prox, the stream bitwise, v within SHARD_RTOL
    def dist_err(leaves, state) -> float:
        w = state.v.double().cpu().numpy()
        return float(np.abs(leaves[0] - w).max() / np.abs(w).max())

    err64 = dist_err(r0[1]["leaves"], short)
    err_all = dist_err(r0[2]["leaves"], want)
    if not (shard_stream_equal(r0[1]["leaves"], short)
            and shard_stream_equal(r0[2]["leaves"], want)):
        fail(f"21c {SHARD_RANKS} ranks, distributed prox: the event stream "
             "differs from the batch engine's")
    if not err64 <= SHARD_RTOL:
        fail(f"21c {SHARD_RANKS} ranks, distributed prox: after "
             f"{SHARD_GATE_EVENTS} events max |v - v_batch| / max |v_batch| "
             f"= {err64:.3g} > {SHARD_RTOL}")
    times[f"{SHARD_RANKS} ranks distributed"] = shard_times(
        f"21c {SHARD_RANKS} ranks, distributed prox", r0[2], dist_cfg, card)
    log(f"phase 21c {SHARD_RANKS} ranks, distributed prox: the event stream "
        f"bitwise; max |v - v_batch| / max |v_batch| {err64:.3g} <= "
        f"{SHARD_RTOL} after {SHARD_GATE_EVENTS} events, {err_all:.3g} "
        f"after {BATCH_EVENTS}: PASS")

    # 21d: the straggler regime
    lv = r0[3]["leaves"]
    buf, count = lv[6], lv[7]
    mean = buf.sum(axis=1) / np.maximum(np.minimum(count, buf.shape[1]), 1)
    half = T // SHARD_RANKS
    if not (np.array_equal(lv[0], lagged.v.cpu().numpy())
            and shard_stream_equal(lv, lagged)):
        fail("21d straggler: not bitwise the batch engine's run at the same "
             "offsets")
    if not (mean[:half].min() >= 2.0 and mean[half:].max() <= 1.0
            and count[:half].sum() > 0 and count[half:].sum() > 0):
        fail(f"21d straggler: mean delays {mean[:half].min():.3g} (lagging "
             f"shard, min) and {mean[half:].max():.3g} (other, max), counts "
             f"{count[:half].sum()} and {count[half:].sum()}")
    log(f"phase 21d straggler (rank 0's tasks at offset {TAU}): bitwise the "
        f"batch engine's run; the lagging shard's mean delay >= "
        f"{mean[:half].min():.3g}, the other's <= {mean[half:].max():.3g}, "
        f"{count[:half].sum()} and {count[half:].sum()} activations: PASS")

    # 21e: save at the midpoint, restore into a fresh world, run on
    if not all(np.array_equal(a, b) for a, b in
               zip(r0[4]["leaves"], r0[0]["leaves"])):
        fail("21e checkpoint: the run that saved differs from 21b's")
    t1 = time.perf_counter()
    again = run_world(amtl_sharded.session, SHARD_RANKS, dict(
        device=dev.type, problems=problems,
        runs=[dict(base, cfg=fields(repl),
                   restore=(str(ckpt), BATCH_EVENTS // 2))]),
        device=dev.type, timeout=SHARD_WORLD_TIMEOUT_S,
        collective_timeout=SHARD_COLLECTIVE_TIMEOUT_S,
        workdir=str(ROOT / "build"))
    world_s += time.perf_counter() - t1
    shutil.rmtree(ckpt, ignore_errors=True)
    if not all(np.array_equal(a, b) for a, b in
               zip(again[0][0]["leaves"], r0[0]["leaves"])):
        fail("21e checkpoint: the restored world's run is not bitwise the "
             "uninterrupted run")
    log(f"phase 21e checkpoint: saved at event {BATCH_EVENTS // 2} by "
        f"{SHARD_RANKS} ranks, restored into a fresh world and run to "
        f"{BATCH_EVENTS}: bitwise the uninterrupted run: PASS")

    # 21f: SGD on the ragged store
    lv = r0[5]["leaves"]
    if not (np.array_equal(lv[0], sgd.v.cpu().numpy())
            and shard_stream_equal(lv, sgd)
            and shard_owned_ring_equal(lv, sgd)):
        fail("21f ragged SGD: the gathered state is not bitwise the ragged "
             "SGD batch session's")
    for r in range(SHARD_RANKS):
        got = out[r][5]["launches"]["lstsq_grad_sampled"]
        if dev.type == "cuda" and got != owned_steps[r]:
            fail(f"21f: rank {r} launched lstsq_grad_sampled {got} times; "
                 f"want {owned_steps[r]} (the steps with an event of the "
                 "rank's)")
    log(f"phase 21f {SHARD_RANKS} ranks, SGD (batch_size "
        f"{sgd_cfg.batch_size}) on the ragged store: bitwise the ragged SGD "
        f"batch session; each rank's launches {r0[5]['launches']}: PASS")
    log(f"phase 21 worlds: {world_s:.1f} s with spawn and set-up")
    kernels = shard_kernel_times(dev, seed) if dev.type == "cuda" else {}
    log("sharded " + json.dumps({"card": card, "times": times,
                                 "kernels": kernels}))
    return {"launches": sharded_launches,
            "rank_launches": r0[0]["launches"], "kernels": kernels}


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
    if b["counts"]["lstsq_grad"] != need:
        fail(f"batch session: lstsq_grad launched {b['counts']['lstsq_grad']}"
             f" != {need} times (one a batch step)")
    obj1 = objective(problem, batch_cfg, b["v"])
    if not obj1 < obj0:
        fail(f"batch session: objective did not fall ({obj0} -> {obj1})")
    log(f"phase 4 batch session: {BATCH_EVENTS} events, launches "
        f"{b['counts']}, objective {obj0:.6g} -> {obj1:.6g}: PASS")
    matched = delta_cfg._replace(prox_every=BATCH)
    fb = run_session(problem, batch_cfg, v0, key, offs, CPU_EVENTS,
                     dev)["state"]
    fd = run_session(problem, matched, v0, key, offs, CPU_EVENTS,
                     dev)["state"]
    if not (torch.equal(fb.v.view(torch.int32), fd.v.view(torch.int32))
            and np.array_equal(fb.task_ring, fd.task_ring)):
        fail("uniform full-gradient batch and delta sessions differ on the "
             f"card at a matched cadence (max |diff| "
             f"{(fb.v - fd.v).abs().max().item()})")
    log(f"phase 4 uniform full-gradient batch == delta bitwise on the card at "
        f"prox_every {BATCH} ({CPU_EVENTS} events): PASS")

    # phase 5: delta-engine session
    dl = run_session(problem, delta_cfg, v0, key, offs, DELTA_EVENTS, dev)
    if not bool(torch.isfinite(dl["v"]).all()):
        fail("delta session: iterate not finite")
    for k in ("amtl_event", "lstsq_grad"):
        if dl["counts"][k] != DELTA_EVENTS:
            fail(f"delta session: {k} launched {dl['counts'][k]} != "
                 f"{DELTA_EVENTS} times")
    refreshes = DELTA_EVENTS // DELTA_PROX_EVERY
    for k in ("gauss_sketch", "svt_reconstruct"):
        if dl["counts"][k] < refreshes:
            fail(f"delta session: {k} launched {dl['counts'][k]} < "
                 f"{refreshes} times")
    log(f"phase 5 delta session: {DELTA_EVENTS} events, launches "
        f"{dl['counts']}: PASS")
    report_busy("delta session", problem, delta_cfg, v0, key, offs,
                DELTA_EVENTS, dl["device"], dev, phase=5)

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

    # phase 7: SGD-AMTL on ragged cohorts published by a TaskStore
    store, rows = make_store(args.seed)
    sgd_batch, sgd_delta = sgd_configs()
    rp0 = store.problem(dev)
    obj0 = objective(rp0, sgd_batch, v0)
    rb = ragged_batch_session(store, rows, sgd_batch, v0, key, offs,
                              args.seed, dev)
    rp = rb["problem"]
    if not bool(torch.isfinite(rb["v"]).all()):
        fail("ragged batch session: iterate not finite")
    batches = BATCH_EVENTS // BATCH
    want = {"lstsq_grad_sampled": batches, "amtl_event_batch": batches,
            "gauss_sketch": batches, "svt_reconstruct": batches,
            "lstsq_grad": 0}
    for k, n in want.items():
        if rb["counts"][k] != n:
            fail(f"ragged batch session: {k} launched {rb['counts'][k]} != "
                 f"{n} times")
    obj1 = objective(rp, sgd_batch, rb["v"])
    if not obj1 < obj0:
        fail(f"ragged batch session: objective did not fall ({obj0} -> "
             f"{obj1})")
    log(f"phase 7 ragged SGD batch session: cohorts {int(rp0.host_row_counts().min())}"
        f"..{int(rp0.host_row_counts().max())} rows (capacity "
        f"{store.capacity}, {store.num_rows - APPEND_ROWS} rows), "
        f"{BATCH_EVENTS} events in two chunks with {APPEND_ROWS} rows "
        f"appended to {rb['grown']} tasks between them ({rb['append']:.3f} s,"
        f" no doubling; the second chunk draws over the new counts), "
        f"launches {rb['counts']}, objective {obj0:.6g} -> {obj1:.6g}: PASS")

    rd = run_session(rp, sgd_delta, v0, key, offs, DELTA_EVENTS, dev)
    if not bool(torch.isfinite(rd["v"]).all()):
        fail("ragged delta session: iterate not finite")
    for k in ("lstsq_grad_sampled", "amtl_event"):
        if rd["counts"][k] != DELTA_EVENTS:
            fail(f"ragged delta session: {k} launched {rd['counts'][k]} != "
                 f"{DELTA_EVENTS} times")
    log(f"phase 7 ragged SGD delta session: {DELTA_EVENTS} events, launches "
        f"{rd['counts']}: PASS")

    logistic = rp._replace(ys=torch.where(rp.ys > 0, 1.0, -1.0),
                           loss_name="logistic")
    rl = run_session(logistic, sgd_delta, v0, key, offs, LOGISTIC_EVENTS, dev)
    if not bool(torch.isfinite(rl["v"]).all()):
        fail("logistic delta session: iterate not finite")
    if rl["counts"]["sample_mask"] != LOGISTIC_EVENTS \
            or rl["counts"]["amtl_event"] != LOGISTIC_EVENTS \
            or rl["counts"]["lstsq_grad_sampled"] != 0 \
            or rl["counts"]["lstsq_grad"] != 0:
        fail(f"logistic delta session: launches {rl['counts']}, want one "
             "sample_mask (the kept rows) and one amtl_event an event")
    log(f"phase 7 logistic SGD delta session: {LOGISTIC_EVENTS} events, "
        f"launches {rl['counts']}: PASS")

    sg_counts, sg_worst = store_gradients(rp, rb["v"], dev)
    if sg_counts["lstsq_grad"] != T + 2:
        fail(f"store gradients: lstsq_grad launched {sg_counts['lstsq_grad']}"
             f" != {T} + 2 times")
    log(f"phase 7 store gradients: the masked full gradient of {T} tasks "
        f"through ops.lstsq_grad one task at a time, one "
        f"ops.lstsq_grad_batch and full_grad (one launch each), launches "
        f"{sg_counts}; all three bitwise, within {sg_worst:.3g} of 2 |X|^T "
        f"|r| of the plain version: PASS")

    # phase 8: the card against the port's CPU run; batch == delta
    rp_cpu = store.problem(cpu)
    worst = {}
    for label, cfg in (("sgd batch", sgd_batch), ("sgd delta", sgd_delta)):
        card_s = run_session(rp, cfg, v0, key, offs, CPU_EVENTS,
                             dev)["state"]
        cpu_s = run_session(rp_cpu, cfg, v0.cpu(), key, offs, CPU_EVENTS,
                            cpu)["state"]
        worst[label] = compare_states(label, card_s, cpu_s)
    del rp_cpu
    matched = sgd_delta._replace(prox_every=BATCH)
    sb = run_session(rp, sgd_batch, v0, key, offs, CPU_EVENTS, dev)["state"]
    sd = run_session(rp, matched, v0, key, offs, CPU_EVENTS, dev)["state"]
    if not (torch.equal(sb.v.view(torch.int32), sd.v.view(torch.int32))
            and np.array_equal(sb.task_ring, sd.task_ring)):
        fail("ragged SGD batch and delta sessions differ on the card at a "
             f"matched cadence (max |diff| {(sb.v - sd.v).abs().max().item()})")
    log(f"phase 8 ragged SGD card vs CPU ({CPU_EVENTS} events): event "
        f"streams bitwise, max relative |diff| of v/delta_ring {worst} <= "
        f"{SESSION_RTOL}; batch == delta bitwise on the card at prox_every "
        f"{BATCH}: PASS")

    # phase 9: times
    for label, r, n, n_split in (
            ("batch engine", b, BATCH_EVENTS, BATCH_EVENTS),
            ("delta engine", dl, DELTA_EVENTS, DELTA_EVENTS),
            ("ragged SGD batch (two chunks; split of the second)", rb,
             BATCH_EVENTS, rb["plan_events"]),
            ("ragged SGD delta", rd, DELTA_EVENTS, DELTA_EVENTS),
            ("logistic SGD delta", rl, LOGISTIC_EVENTS, LOGISTIC_EVENTS)):
        report_session(label, r, n, n_split)
    log(f"phase 9 ragged SGD batch: the host plan of {rb['plan_events']} "
        f"events takes {rb['host']:.3f} s with the minibatch seeds and "
        f"cutoffs and {rb['host_full']:.3f} s without "
        f"({1e6 * (rb['host'] - rb['host_full']) / rb['plan_events']:.1f} "
        "us an event)")
    for label, prob, cfg, n, r in (
            ("batch engine", problem, batch_cfg, BATCH_EVENTS, b),
            ("ragged SGD batch", rp, sgd_batch, rb["plan_events"], rb),
            ("ragged SGD delta", rp, sgd_delta, DELTA_EVENTS, rd),
            ("logistic SGD delta", logistic, sgd_delta, LOGISTIC_EVENTS,
             rl)):
        report_busy(label, prob, cfg, v0, key, offs, n, r["device"], dev)

    # phases 15-19: the dense engine and the l2,1 formulation
    dense_counts = l21_phases(problem, problem_cpu, v0, key, offs, dev)
    del problem_cpu
    torch.cuda.empty_cache()

    # phases 10-11: gemma2-2b serving at full width; 13-14: rwkv6-3b
    sv = serve_phase(dev, args.seed, card, "gemma2-2b")
    torch.cuda.empty_cache()
    rw = serve_phase(dev, args.seed, card, "rwkv6-3b")
    torch.cuda.empty_cache()

    # phase 20: the learn-while-serve AMTLServer at the engine cells' width
    amtl_serve = amtl_serve_phase(dev, args.seed, card)
    torch.cuda.empty_cache()

    # phase 21: the task-sharded engine, one rank and SHARD_RANKS ranks
    sharded = sharded_phase(dev, args.seed, card, problem, v0, offs, key, b)
    torch.cuda.empty_cache()

    kernels = []
    info["lstsq_grad"]["args"] = grad_inputs(dev, args.seed)
    launches = {k: (dl if k == "amtl_event" else b)["counts"][k]
                for k in ("amtl_event", "amtl_event_batch", "gauss_sketch",
                          "svt_reconstruct")}
    launches.update(lstsq_grad_sampled=rb["counts"]["lstsq_grad_sampled"],
                    sample_mask=rl["counts"]["sample_mask"],
                    lstsq_grad=b["counts"]["lstsq_grad"],
                    flash_attention=sv["counts"]["flash_attention"],
                    rwkv6_scan=rw["counts"]["rwkv6_scan"],
                    km_update=dense_counts["km_update"],
                    l21_prox=dense_counts["l21_prox"])
    where = {"amtl_event": "delta session", "sample_mask":
             "logistic SGD delta session (the kept rows, one launch an "
             "event)", "lstsq_grad": "batch session (one launch a batch "
                                     "step of 32 events)",
             "lstsq_grad_sampled": "ragged SGD batch session (one launch "
                                   "a batch step of 32 events)",
             "flash_attention": "gemma2-2b serve (B 2, prompt 5000, gen 32)",
             "rwkv6_scan": "rwkv6-3b serve (B 2, prompt 5000, gen 32)",
             "km_update": "dense l21 session (one slot update an event)",
             "l21_prox": "dense l21 session"}
    for name in ("amtl_event_batch", "gauss_sketch", "svt_reconstruct",
                 "amtl_event", "lstsq_grad_sampled", "sample_mask",
                 "lstsq_grad", "km_update", "l21_prox", "flash_attention",
                 "rwkv6_scan"):
        spec = kernel_spec(name, info[name]["args"], dev)
        kern = spec["kern"]
        saved = kern.launches
        k_ms = cuda_ms(spec["kfn"])
        issue_ms = cuda_ms(spec["kfn"], backlog=False)
        # the sequential plain WKV loops over 5000 tokens in Python
        slow = name == "rwkv6_scan"
        p_ms = cuda_ms(spec["pfn"], reps=3 if slow else 21,
                       warmup=1 if slow else 3, inner=1, backlog=False)
        if name == "flash_attention":
            l_ms = None     # flash_times times it with each route, below
        else:
            l_ms = cuda_ms(spec["lib"]) if spec["lib"] is not None else None
        kern.launches = saved           # timing launches are not the path's
        bnd, by = bound_ms(spec["nbytes"], spec["flops"], spec["rate"])
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{spec['src']}",
            replaces=spec["rep"], launches=launches[name],
            max_abs_err=info[name]["err"], ms=k_ms, plain_ms=p_ms,
            bound_ms=bnd, bound_by=by, library_ms=l_ms))
        log(f"phase 12 {name}: {k_ms * 1e3:.2f} us on the device (bound "
            f"{bnd * 1e3:.2f} us by {by}; {issue_ms * 1e3:.2f} us a call "
            f"when the host issues them one by one), plain "
            f"{p_ms * 1e3:.1f} us, library "
            + ("n/a" if l_ms is None else
               f"{l_ms * 1e3:.2f} us ({LIBRARY_CALLS[name]})")
            + f", {launches[name]} launches on the "
            f"{where.get(name, 'batch session')}")
        if name in amtl_serve["launches"]:
            kernels[-1]["serve_launches"] = amtl_serve["launches"][name]
        if sharded["rank_launches"].get(name):
            kernels[-1]["sharded_launches"] = {
                "1 rank": sharded["launches"][name],
                f"each of {SHARD_RANKS} ranks": sharded["rank_launches"][name]}
        if name in sharded["kernels"]:
            kernels[-1]["shard_shape"] = sharded["kernels"][name]
        if name == "lstsq_grad_sampled":
            kernels[-1].update(sampled_single_times(info[name], dev))
        if name == "lstsq_grad":
            kernels[-1].update(grad_times(info[name]["args"], dev))
            del info[name]["args"]          # 1.07 GB
            torch.cuda.empty_cache()
        if name == "sample_mask":
            kernels[-1].update(mask_bits_times(info, dev))
        if name == "amtl_event_batch":
            kernels[-1].update(event_batch_times(info[name]["args"], k_ms))
        if name in ("amtl_event", "km_update"):
            kernels[-1].update(engine_form_times(name, info, dev))
        if name in ("gauss_sketch", "svt_reconstruct"):
            cold = sketch_recon_cold(name, info[name]["args"], dev)
            kernels[-1].update(cold)
            log(f"phase 12 {name} L2-cold ({COLD_INPUTS} distinct inputs in "
                f"turn): {cold['l2_cold_ms'] * 1e3:.2f} us on the device, "
                f"library {cold['library_l2_cold_ms'] * 1e3:.2f} us; "
                f"L2-warm {k_ms * 1e3:.2f} us, library {l_ms * 1e3:.2f} us; "
                f"plan {cold['plan']}")
    flash = kernels[[k["name"] for k in kernels].index("flash_attention")]
    flash["routes"] = flash_times(info["flash_attention"]["served"], dev)
    flash["library_ms"] = flash["routes"]["sm90"]["library_ms"]
    wkv = kernels[[k["name"] for k in kernels].index("rwkv6_scan")]
    wkv["routes"] = rwkv_times(info["rwkv6_scan"], rw["routes"])
    l21_km_times(info)
    parts = prox_refresh_breakdown(dev, args.seed)
    log(f"phase 12 prox refresh (svt_randomized, d {D}, T {T}, rank {RANK}, "
        f"p {RANK + 8}), L2-cold over {COLD_INPUTS} iterates: "
        + "; ".join(f"{k} {v['stream_ms'] * 1e3:.2f} us stream, "
                    f"{v['device_ms'] * 1e3:.2f} us in "
                    f"{v['device_events']:.1f} profiled device events, "
                    f"{v['host_syncs']} host syncs"
                    for k, v in parts.items())
        + "; synchronizing the host: "
        + (", ".join(k for k, v in parts.items() if v["host_syncs"]) or "none"))
    log("prox_refresh " + json.dumps(parts))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
