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
kernel; granite-8b, nemotron-4-15b and gemma3-12b the same way, phases
26-28; zamba2-7b, its Mamba-2 SSD in plain PyTorch and its shared
attention at hd 112 in the tensor-core kernel zero-filled to 128 columns,
and
llama-3.2-vision-11b, its gated cross-attention over stub vision
embeddings, phases 29-30, each also in its reduced config against the
CPU) and rwkv6-3b serving (every bf16 prefill WKV in the chunked
tensor-core kernel and every decode WKV in the recurrent one), the dense
engine and the l2,1 (joint feature learning) formulation (dense sessions
with the km_update and l21_prox kernels, dense == delta bitwise, a batch
l2,1 session, FISTA's reference optimum) and the learn-while-serve
`AMTLServer` on the ragged store (cooperative serving with a checkpoint
and a bitwise resume, threaded learning, chaos under a FaultPlan), and
the task-sharded engine (one rank in process, then two ranks sharing
the card in a gloo world: both proxes, a straggler shard, a checkpoint
restored in a second world, SGD on the ragged store), and gemma2-2b
training with the AMTL head in every step (phase 24: AdamW steps at full
width, every attention forward in the flash kernel and every backward in
the tensor-core flash backward kernel, step 0 against the plain attention,
the head's rounds against a CPU replay) and rwkv6-3b training (phase 25:
every WKV forward in the chunked kernel, every backward in the WKV
backward kernel, step 0 against the plain WKV under autograd), and
hubert-xlarge, the audio encoder, at its published width (phase 31: its
forward over B 8 x 781 frames, every attention call in the tensor-core
flash kernel at hd 80 zero-filled to 128 columns; phase 32: training with
the AMTL head, every backward in the tensor-core flash backward kernel at
the same padded width), and zamba2-7b and llama-3.2-vision-11b trained at
their published widths with their depth cut (phases 33-34: the SSD under
autograd, the tied shared attention with its LoRA, the gated
cross-attention, every attention backward in the tensor-core kernel), and
dbrx-132b and deepseek-v3-671b served at their published widths with
their depth cut (phases 35-36: the routed MoE FFN, deepseek's MLA prefill
in the tensor-core kernel at qk hd 192 and its absorbed decode in plain
PyTorch, each also in its reduced config against the CPU), and both
trained at their published widths with their depth cut under Adafactor
(phases 37-38: dbrx on its first layer, the routed MoE's backward;
deepseek on its 3 dense MLA layers and the MTP block, MLA's backward in
the tensor-core flash backward at 192 columns; each reduced config's
gradients also against the CPU), and granite-8b served at its published
widths with the int8 KV cache beside its bf16 cache (phase 39: the int8
run against the plain attention and against the bf16 run, a control
without the scales, the reduced config against the CPU), the twins of
examples/serve_batched.py and train_lm.py on the card (phase 40) and the
meta-device dry run of every arch and shape (phase 41) — holds
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
import collections
import contextlib
import dataclasses
import hashlib
import json
import math
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
# gradient, randomized SVT): 8 request batches, each 64 prediction rows and
# 64 labelled feedback rows (task ids uniform), 512 events in all; the
# resume after batch 4 (the one checkpoint, at 320 events; 16 batches and
# two records, at 512 and 1024, took 203.5 s of the smoke on an H100
# host, ~70 s of it the second record written, verified and resumed).
# The chaos drive serves the first SERVE_CHAOS_BATCHES batches and writes
# its two records by explicit calls.  The SLO controller decides every
# SERVE_SLO_WINDOW predict latencies, so each of the phase's servers (8, 3
# and 8 predicts) closes at least one window.  Checkpoints go under
# build/serve_ckpt (a store record is 1.7-3.3 GB; the phase needs
# SERVE_FREE_BYTES free under build/, checked with HOST_FREE_BYTES of the
# host's memory before any phase runs, and deletes the directory at its
# end).  HOST_FREE_BYTES: the parent's peak resident bytes (44.74 GB, its
# ru_maxrss at phase 22 on an H100 host) and LOCK_RANKS ranks' own peaks
# (8.49 GB each) are 61.72 GB, 57.5 GiB; 64 GiB leaves 6.5 GiB over them.
SERVE_BATCHES, SERVE_ROWS, SERVE_RESUME_AT, SERVE_CHAOS_BATCHES = 8, 64, 5, 7
SERVE_CFG = dict(chunk_events=128, task_chunk_quota=8, max_pending_per_task=64,
                 max_batch=256, slo_ms=250.0, slo_window=32, keep_last=2,
                 checkpoint_every=320)
SERVE_SLO_WINDOW = 3
SERVE_FREE_BYTES = 24e9
HOST_FREE_BYTES = 64 * 2 ** 30
SERVE_WAIT_S = 300.0

# The learn-while-serve server on LOCK_RANKS ranks stepping in lockstep
# (phase 22, `launch.serve_lockstep`) on this card (gloo), at the store and
# the SERVE_CFG above on the sharded engine (the batch cell's config): the
# first LOCK_BATCHES request batches, a save after LOCK_SAVE_AT of them
# (resumed at LOCK_RANKS ranks in another world and at one rank), the
# threaded drain of LOCK_THREADED batches' feedback with a crash on rank 1,
# and the distributed prox over LOCK_DIST_BATCHES batches, each against the
# one-rank server (batch engine) in this process.  Records go under
# build/serve_ckpt/lockstep.  (12 batches, the save after 8, took 171.7 s
# of the smoke on an H100 host; 6 and 4, 118.3-139.0 s; 4 and 2, 150.1 s
# on a slower host: the phase's time is its worlds and set-up, not its
# batches.)
LOCK_RANKS, LOCK_BATCHES, LOCK_SAVE_AT = 2, 6, 4
LOCK_THREADED, LOCK_DIST_BATCHES, LOCK_PREDICTS = 3, 4, 64

# The twins of examples/quickstart.py and hospitals_async.py (phase 23), on
# the card against their own CPU runs: objectives within TWIN_OBJ_RTOL, the
# fixed-point residual and the gap to the optimum within TWIN_RESIDUAL_ATOL,
# the predictions' drift within TWIN_DRIFT_RTOL; the float64 simulator
# exactly.
TWIN_OBJ_RTOL, TWIN_RESIDUAL_ATOL, TWIN_DRIFT_RTOL = 1e-5, 1e-4, 1e-4

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


def mark(t0: float, phases: str) -> None:
    """The seconds into the smoke at the end of `phases`."""
    log(f"phases {phases} done {time.perf_counter() - t0:.1f} s into the "
        "smoke")


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
    info.update(check_flash_bwd(dev, gen))
    info.update(check_rwkv_kernel(dev, gen))
    info.update(check_wkv_bwd(dev, gen))
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


def masked_attention(q, k, v, keep, softcap, rows: int = 1024):
    """Dense softmax attention with an explicit (Sq, Skv) keep mask, in
    float32 over blocks of `rows` query rows, out in q's dtype; a row with
    no kept key gives 0.  The flash gate's controls: the served masks with
    a tile changed."""
    import torch
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    kf, vf = k.float(), v.float()
    outs = []
    for r0 in range(0, sq, rows):
        qg = q[:, r0:r0 + rows].float().reshape(b, -1, hkv, h // hkv, hd)
        x = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
        x = x.masked_fill(~keep[r0:r0 + rows], float("-inf"))
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


SM90_SENTINEL = -1024.0    # exact in bf16, far from any attention output
SM90_REPEATS = 10          # further launches that must repeat the output


def sm90_canary(label: str, args_, got) -> None:
    """The sm90 launcher writing into the head of a sentinel-filled
    buffer 4096 elements longer than the output: the tail must still hold
    the sentinel (a store past hd at the last row and head would reach it)
    and the head must be the wrapper's output, bit for bit; and
    SM90_REPEATS more launches through the wrapper, each bit for bit
    (`launch/sm90_repeat.py` counts them at windowed shapes)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as k_flash
    q, k, v, kw = args_
    b, sq, skv, h, hkv, hd, window, cap, kv_len = k_flash.check_call(
        "sm90 canary", q, k, v, kw["window"], kw["softcap"], kw["kv_len"])
    n = q.numel()
    buf = torch.full((n + 4096,), SM90_SENTINEL, dtype=q.dtype,
                     device=q.device)
    fn = _build.function("flash_attention_sm90_launch",
                         k_flash._SM90_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), b,
             sq, skv, h, hkv, hd, int(kw["causal"]), window, cap,
             int(kw["q_offset"]), kv_len, k_flash.softmax_scale(hd),
             _build.stream(q.device))
    _build.check(err, "sm90 canary")
    if not bool((buf[n:] == SM90_SENTINEL).all()):
        fail(f"flash_attention {label}: the sm90 kernel wrote past the end "
             f"of its output (hd {hd}, padded to {k_flash.sm90_width(hd)})")
    head = buf[:n].view_as(got)
    if not torch.equal(head, got):
        bad = (head != got).nonzero()
        fail(f"flash_attention {label}: the sm90 launch into a buffer "
             f"differs from the wrapper's output at {len(bad)} of {n} "
             f"elements (max |diff| "
             f"{(head.float() - got.float()).abs().max().item():.3g}; "
             f"(b, row, head, column) first {bad[0].tolist()}, last "
             f"{bad[-1].tolist()})")
    again = sum(not torch.equal(k_flash.flash_attention(
        q, k, v, route="sm90", **kw), got) for _ in range(SM90_REPEATS))
    if again:
        fail(f"flash_attention {label}: {again} of {SM90_REPEATS} further "
             "sm90 launches differ from the first")


def sm90_scale_control(label: str, args_, got, rows, limit: float) -> str:
    """The sm90 output at an hd below its padded width HP against the
    plain version on q, k, v zero-padded to HP, whose softmax scale is
    1/sqrt(HP): the row gate must see that scale."""
    import torch
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.kernels import ref
    q, k, v, kw = args_
    hd = q.shape[3]
    hp = k_flash.sm90_width(hd)
    pad = [torch.nn.functional.pad(t, (0, hp - hd)) for t in (q, k, v)]
    wrong = ref.mha_ref(*pad, causal=kw["causal"], window=kw["window"],
                        softcap=kw["softcap"], q_offset=kw["q_offset"],
                        kv_valid_len=kw["kv_len"], kv_chunk=SM90_CHUNK,
                        p_dtype=torch.bfloat16)[..., :hd]
    err = row_err(got, wrong, rows)
    if not err > limit:
        fail(f"flash control {label} (scale 1/sqrt({hp}), not 1/sqrt({hd})):"
             f" {err:.3g} <= {limit}: the row gate does not see it")
    return f"{label} {err:.3g}"


# MLA's v columns (v_head_dim) in the qk width of 192 at deepseek-v3-671b's
# prefill: the rest of v is the zero padding of `_mha_mixed_dims`.
MLA_V_COLS = 128


def check_flash_kernel(dev, gen) -> dict:
    """The flash-attention kernels against their plain versions on the
    card, in float32 and bfloat16: at the served shapes (prefill of a global
    and of a local layer, decode on the ring and on the global cache), and
    at edge cases, each route that takes a case forced in turn, by FLASH_TOL
    and by FLASH_ROW_TOL (with its controls at the served shapes, and at
    every hd that sm90 pads, the plain version scaled by 1/sqrt(HP)); every
    sm90 run also launched into a sentinel-filled buffer (`sm90_canary`);
    the (S, H, hd) entry point.  Returns the bfloat16 served cases (on the
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
        # zamba2-7b's hd 112: the prefill (sm90 at 128 columns, the 16
        # past hd zero-filled) with H = Hkv, the decode on split
        ("hd 112, H = Hkv 32", 1, 300, 300, 32, 32, 112, True, None, None, 0,
         None),
        ("hd 112 decode, H = Hkv 32", 2, 1, 1000, 32, 32, 112, False, None,
         None, 900, 901),
        # llama-3.2-vision-11b's cross-attention: non-causal, Sq != Skv,
        # Skv 1601 not a multiple of a key tile, GQA 4; its decode with 4
        # rows a kv head over the 1601 keys
        ("cross: Sq 300 over 1601 keys, GQA 4", 2, 300, 1601, 32, 8, 128,
         False, None, None, 0, None),
        ("cross decode over 1601 keys, GQA 4", 2, 1, 1601, 32, 8, 128, False,
         None, None, 0, None),
        # head dims off the 64-column boxes: sm90 zero-fills each row to
        # the next 64 columns (hubert's hd 80, zamba2's 112 with partial key
        # tiles, a window and a softcap, MLA's qk hd 192) and, below 64, a
        # box wider than the row (hd 8 and 48)
        ("hd 80, non-causal, H 16", 2, 200, 200, 16, 16, 80, False, None,
         None, 0, None),
        ("hd 112, S 300, GQA 2", 1, 300, 300, 32, 16, 112, True, None, None,
         0, None),
        ("hd 112, S 1000, window 256, softcap 50, GQA 2", 2, 1000, 1000, 32,
         16, 112, True, 256, 50.0, 0, None),
        ("hd 192, GQA 4, q_offset 256, kv_len 450", 1, 200, 500, 16, 4, 192,
         True, None, 30.0, 256, 450),
        ("hd 8, GQA 2", 2, 100, 100, 4, 2, 8, True, None, None, 0, None),
        ("hd 48, window 16, softcap 30", 1, 130, 130, 4, 2, 48, True, 16,
         30.0, 0, None),
        # deepseek-v3-671b's MLA prefill: q and k at nope 128 + rope 64 =
        # 192 columns, H = Hkv 128, v zero-padded from 128 (MLA_V_COLS),
        # so the output's last 64 columns must be exactly 0
        ("MLA prefill: hd 192, H = Hkv 128, v zero past 128", 1, 200, 200,
         128, 128, 192, True, None, None, 0, None),
        # dbrx-132b's decode: 6 query rows a kv head (H 48, Hkv 8) over the
        # 5008-slot cache
        ("dbrx decode: H 48, Hkv 8, hd 128", 2, 1, SERVE_PROMPT + DENSE_GEN,
         48, 8, 128, False, None, None, SERVE_PROMPT + 5, SERVE_PROMPT + 6),
    ]
    served, worst, row_worst, split_worst, runs = {}, {}, {}, {}, 0
    scale_controls, canaries, mla_zero = [], 0, 0
    controls, empty = [], 0
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for label, b, sq, skv, h, hkv, hd, causal, window, cap, qo, kvl \
                in cases:
            q = torch.randn(b, sq, h, hd, generator=gen, device=dev).to(dt)
            k = torch.randn(b, skv, hkv, hd, generator=gen, device=dev).to(dt)
            v = torch.randn(b, skv, hkv, hd, generator=gen, device=dev).to(dt)
            mla = label.startswith("MLA")
            if mla:
                v[..., MLA_V_COLS:] = 0
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
                if route == "sm90":
                    sm90_canary(label, (q, k, v, kw), got)
                    canaries += 1
                if mla and bool(got[..., MLA_V_COLS:].any()):
                    fail(f"flash_attention {label} {dt_name} route {route}: "
                         f"the output past column {MLA_V_COLS}, where v is "
                         "zero, is not exactly 0")
                mla_zero += mla
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
                if route == "sm90" and k_flash.sm90_width(hd) != hd:
                    scale_controls.append(sm90_scale_control(
                        label, (q, k, v, kw), got, rows,
                        FLASH_ROW_TOL[dt_name]))
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
        + f"; MLA's output past column {MLA_V_COLS} (v zero there) exactly 0 "
        f"in {mla_zero} runs"
        + f"; {canaries} sm90 launches into a sentinel-filled buffer: tail "
        f"intact, output bitwise the wrapper's and {SM90_REPEATS} further "
        "launches'"
        + "; sm90 at hd off the 64-column boxes against the plain version "
        "scaled by 1/sqrt(HP) (must exceed the row gate): "
        + "; ".join(scale_controls)
        + "; row-gate controls (bf16, dense plain version against the "
        "route's): " + "; ".join(controls)
        + "; at the served shapes (B 2, S 5000, H 8, Hkv 4, hd 256: prefill "
        "with window 4096 and none, softcap 50; decode on a 4096-slot ring "
        "and a 5032-slot cache) and edge cases (S 37, 129; Hkv 1, GQA 8:1; hd "
        "64/72/128; window >= S, window emptying splits; q_offset; kv_len 1, "
        "64, 100; splits past the causal edge; Sq 3 decode; rows with no "
        "kept key), zamba2-7b's hd 112 (H = Hkv 32, prefill and decode; GQA "
        "2 at S 300 and at S 1000 with window 256 and softcap 50), hd 8, 48, "
        "80 (non-causal, H 16) and 192 (GQA 4, q_offset, kv_len), "
        "llama-3.2-vision-11b's cross-attention (Sq 300 and 1 over 1601 "
        "keys, GQA 4, non-causal), deepseek-v3-671b's MLA prefill (hd 192, "
        "H = Hkv 128, v zero past 128), dbrx-132b's decode (6 rows a kv "
        "head over 5008 slots); ops.flash_attention against the O(S^2) "
        "oracle")
    return {"flash_attention": dict(served["prefill global"], served=served)}


# ------------------------------------------------- flash attention backward --

# Each backward route against its plain version on the same o and do, by
# each gradient's max |diff| over its max |value|: `simt` against
# `ref.mha_bwd_ref` (float32 formulas), `sm90` against
# `ref.mha_bwd_ref(..., p_dtype=torch.bfloat16)` (P and dS rounded to bf16
# where they feed a product, as the kernel rounds them).  In float32 the
# two sum 2 hd-long dots and up to S-long sums in other orders: 1e-4.  In
# bf16 both take the same rounded inputs, compute in float32 and round
# each gradient once, so they differ by a bf16 ulp of the gradient (2^-8
# of its max at most) plus float32 noise (for sm90 also the other side of
# a bf16 rounding of some P and dS terms): 2^-7.
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
BWD_TILE = 32              # the controls' shift: simt's BR and BK, sm90's dq key tile
BWD_SOURCES = {"sm90": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
               "simt": "src/repro_torch/csrc/flash_attention_bwd.cu"}
BWD_P_DTYPE = {"sm90": "bfloat16", "simt": None}


def grad_errs(got, want) -> list:
    """max |got - want| / max |want| of each of (dq, dk, dv)."""
    return [((g.float() - w.float()).abs().max()
             / w.float().abs().max().clamp_min(1e-30)).item()
            for g, w in zip(got, want)]


def bwd_plain(route: str, q, k, v, o, do, pkw):
    """The plain version of backward route `route` on these inputs."""
    import torch
    from repro_torch.kernels import ref
    p_dtype = BWD_P_DTYPE[route]
    return ref.mha_bwd_ref(q, k, v, o, do, **pkw, p_dtype=(
        None if p_dtype is None else getattr(torch, p_dtype)))


def bwd_canary(label: str, args_, got) -> None:
    """The sm90 backward's launcher writing dq, dk and dv into the heads of
    sentinel-filled buffers 4096 elements longer than each gradient: every
    tail must still hold the sentinel (a store past hd at the last row and
    head would reach it) and every head must be the wrapper's gradient,
    bit for bit (a store past hd in another row lands in the next head's
    columns)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.kernels import flash_attention_bwd as k_bwd
    q, k, v, o, do, kw = args_
    b, sq, skv, h, hkv, hd, window, cap, kv_len = k_flash.check_call(
        "sm90 bwd canary", q, k, v, kw["window"], kw["softcap"],
        kw["kv_len"], o=o, do=do)
    bufs = [torch.full((t.numel() + 4096,), SM90_SENTINEL, dtype=t.dtype,
                       device=t.device) for t in (q, k, v)]
    rows = -(-sq // k_bwd.SM90_ROWS) * k_bwd.SM90_ROWS
    stats = torch.empty((2, b, h, rows), dtype=torch.float32,
                        device=q.device)
    fn = _build.function("flash_attention_bwd_sm90_launch",
                         k_bwd._SM90_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), *(x.data_ptr() for x in bufs),
             stats[0].data_ptr(), stats[1].data_ptr(), b, sq, skv, h, hkv,
             hd, int(kw["causal"]), window, cap, int(kw["q_offset"]), kv_len,
             k_flash.softmax_scale(hd), _build.stream(q.device))
    _build.check(err, "sm90 bwd canary")
    for name, buf, g in zip(("dq", "dk", "dv"), bufs, got):
        n = g.numel()
        if not bool((buf[n:] == SM90_SENTINEL).all()):
            fail(f"flash_attention_bwd {label}: the sm90 kernels wrote past "
                 f"the end of {name} (hd {hd}, padded to "
                 f"{k_flash.sm90_width(hd)})")
        if not torch.equal(buf[:n].view_as(g), g):
            fail(f"flash_attention_bwd {label}: the sm90 launch into a "
                 f"buffer gives another {name} than the wrapper's")


def bwd_scale_control(label: str, args_, got, limit: float) -> str:
    """The sm90 gradients at an hd below the padded width HP against the
    plain version on q, k, v, o and dO zero-padded to HP, whose softmax
    scale is 1/sqrt(HP): the gate must see that scale."""
    import torch
    from repro_torch.kernels import flash_attention as k_flash
    q, k, v, o, do, kw = args_
    hd = q.shape[3]
    hp = k_flash.sm90_width(hd)
    pad = [torch.nn.functional.pad(t, (0, hp - hd)) for t in (q, k, v, o, do)]
    pkw = dict(causal=kw["causal"], window=kw["window"],
               softcap=kw["softcap"], q_offset=kw["q_offset"],
               kv_valid_len=kw["kv_len"])
    wrong = [g[..., :hd] for g in bwd_plain("sm90", *pad, pkw)]
    err = max(grad_errs(got, wrong))
    if not err > limit:
        fail(f"flash_attention_bwd control {label} (scale 1/sqrt({hp}), not "
             f"1/sqrt({hd})): {err:.3g} <= {limit}: the gate does not see "
             "it")
    return f"{label} {err:.3g}"


def check_flash_bwd(dev, gen) -> dict:
    """The flash-attention backward routes against their plain versions on
    the card: at the training shapes (gemma2-2b, B 2, S 2048, H 8, Hkv 4,
    hd 256, softcap 50: a global layer and a local one, window 4096) and at
    edge cases (a window smaller than S, S not a multiple of the tiles, hd
    64, 72 and 128, float32 and bf16, non-causal, GQA groups 1, 2, 4 and 8,
    rows with no kept key, a query offset and a key count), and at the
    head dims the sm90 kernels compute padded to `sm90_width` (hubert's hd
    80 non-causal at S 781; zamba2's hd 112 causal with GQA 2, a window
    and a softcap; hd 8 and 48, a 64-column box wider than the row; hd 72;
    hd 136 and 192 at the 192-column width; Sq != Skv with a key count and
    a query offset), every route that takes a case (`sm90` bf16 at hd a
    multiple of 8, `simt` all), by FLASH_BWD_TOL; two launches bitwise;
    the default route `sm90` for every bf16 case; at every padded hd the
    sm90 gradients written into sentinel-filled buffers (`bwd_canary`) and
    a control with the scale at 1/sqrt(HP) that must fail the gate
    (`bwd_scale_control`); the autograd path of `ops.mha` launching the
    sm90 route once; and controls at the training shape, for each route,
    that must exceed the limit (its plain version with the causal edge a
    tile later, and with the window a tile wide).  Returns the bf16
    training case with each route's error for the timing phase."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.kernels import flash_attention_bwd as k_bwd
    s = 2048
    # (label, B, Sq, Skv, H, Hkv, hd, causal, window, softcap, q_offset,
    #  kv_len)
    cases = [
        ("train global", 2, s, s, 8, 4, 256, True, None, 50.0, 0, None),
        ("train local", 2, s, s, 8, 4, 256, True, 4096, 50.0, 0, None),
        ("window 300 < S 1000", 1, 1000, 1000, 8, 4, 256, True, 300, 50.0, 0,
         None),
        ("S 37, GQA 4:1, hd 64", 1, 37, 37, 4, 1, 64, True, None, None, 0,
         None),
        ("hd 128, S 257", 1, 257, 257, 8, 4, 128, True, None, 50.0, 0, None),
        ("hd 72, window 16, groups 1", 1, 130, 130, 2, 2, 72, True, 16, None,
         0, None),
        ("non-causal, kv_len 100", 2, 65, 129, 4, 4, 64, False, None, 30.0, 0,
         100),
        ("q_offset 48, kv_len 64", 1, 16, 80, 4, 2, 128, True, 32, None, 48,
         64),
        ("rows with no kept key", 1, 256, 256, 8, 4, 256, True, 64, 50.0, 0,
         100),
        ("GQA 8:1", 1, 300, 300, 8, 1, 128, True, None, None, 0, None),
        ("hubert hd 80, S 781, non-causal", 2, 781, 781, 16, 16, 80, False,
         None, None, 0, None),
        ("hd 112, GQA 2, window 200, softcap 50", 1, 600, 600, 8, 4, 112,
         True, 200, 50.0, 0, None),
        ("hd 8, box wider than the row", 1, 200, 200, 4, 2, 8, True, None,
         None, 0, None),
        ("hd 48, non-causal, softcap 30", 2, 100, 100, 4, 4, 48, False, None,
         30.0, 0, None),
        ("hd 80, Sq 100 != Skv 300, q_offset 150, kv_len 250", 1, 100, 300,
         4, 2, 80, True, None, None, 150, 250),
        ("hd 136 at 192 columns", 1, 300, 300, 8, 2, 136, True, None, None,
         0, None),
        ("hd 192", 1, 300, 300, 16, 4, 192, True, None, None, 0, None),
        (CROSS_LABEL, 2, 2048, 1601, 32, 8, 128, False, None, None, 0, None),
    ]
    # the MoE archs' bf16 training calls (phases 37-38): dbrx-132b's, and
    # deepseek-v3-671b's MLA with v and the output's gradient zero past
    # MLA_V_COLS, as the model pads them
    moe_cases = [
        ("dbrx-132b training, GQA 6", 2, s, s, 48, 8, 128, True, None,
         None, 0, None),
        (MLA_TRAIN_LABEL, 2, s, s, 128, 128, 192, True, None, None, 0,
         None)]
    moe_fwd = {c[0]: None for c in moe_cases}
    worst, runs, train, padded, cross = {}, {}, {}, [], None
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for label, b, sq, skv, h, hkv, hd, causal, window, cap, qo, kvl \
                in cases + (moe_cases if dt_name == "bfloat16" else []):
            q = torch.randn(b, sq, h, hd, generator=gen, device=dev).to(dt)
            k = torch.randn(b, skv, hkv, hd, generator=gen, device=dev).to(dt)
            v = torch.randn(b, skv, hkv, hd, generator=gen, device=dev).to(dt)
            kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo,
                      kv_len=kvl)
            do = torch.randn(b, sq, h, hd, generator=gen, device=dev).to(dt)
            if label == MLA_TRAIN_LABEL:
                v[..., MLA_V_COLS:] = 0
                do[..., MLA_V_COLS:] = 0
            o = k_flash.flash_attention(q, k, v, **kw)
            pkw = dict(causal=causal, window=window, softcap=cap,
                       q_offset=qo, kv_valid_len=kvl)
            if label in moe_fwd:      # the forward at this shape too
                want_o = ref.mha_ref(q, k, v, kv_chunk=64,
                                     p_dtype=torch.bfloat16, **pkw)
                e = ((o.float() - want_o.float()).abs().max()
                     / want_o.float().abs().max()).item()
                if not e <= FLASH_TOL["bfloat16"]:
                    fail(f"flash_attention (sm90) {label}: {e:.3g} of max "
                         f"|o| from its plain version > "
                         f"{FLASH_TOL['bfloat16']}")
                moe_fwd[label] = e
                del want_o
            want_route = "sm90" if k_flash.accepts("sm90", dt, sq, h, hkv,
                                                   hd) else "simt"
            if k_bwd.route(dt, b, sq, skv, h, hkv, hd,
                           skv if kvl is None else kvl) != want_route:
                fail(f"flash_attention_bwd {label} {dt_name}: the default "
                     f"route is not {want_route}")
            for r in k_bwd.ROUTES:
                if not k_bwd.accepts(r, dt, sq, h, hkv, hd):
                    continue
                want = bwd_plain(r, q, k, v, o, do, pkw)
                got = k_bwd.flash_attention_bwd(q, k, v, o, do, route=r,
                                                **kw)
                again = k_bwd.flash_attention_bwd(q, k, v, o, do, route=r,
                                                  **kw)
                torch.cuda.synchronize()
                errs = grad_errs(got, want)
                if any(g.dtype != dt for g in got) or not all(
                        torch.isfinite(g.float()).all() for g in got) \
                        or not max(errs) <= FLASH_BWD_TOL[dt_name]:
                    fail(f"flash_attention_bwd ({r}) {label} {dt_name}: max "
                         f"|diff| / max |grad| (dq, dk, dv) {errs} > "
                         f"{FLASH_BWD_TOL[dt_name]} (or dtype, or not "
                         "finite)")
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    fail(f"flash_attention_bwd ({r}) {label} {dt_name}: two "
                         "launches differ")
                if r == "sm90" and k_flash.sm90_width(hd) != hd:
                    args_ = (q, k, v, o, do, kw)
                    bwd_canary(label, args_, got)
                    padded.append(bwd_scale_control(
                        label, args_, got, FLASH_BWD_TOL[dt_name]))
                key = f"{r} {dt_name}"
                worst[key] = max(worst.get(key, 0.0), max(errs))
                runs[r] = runs.get(r, 0) + 1
                if label == "train global" and dt_name == "bfloat16":
                    abs_err = max((g.float() - w.float()).abs().max().item()
                                  for g, w in zip(got, want))
                    train[r] = dict(err=abs_err, rel_err=max(errs),
                                    got=got)
                if label == CROSS_LABEL and r == "sm90":
                    cross = cross_bwd_checks((q, k, v, o, do, kw), got, errs)
                if label == MLA_TRAIN_LABEL and (
                        got[2][..., MLA_V_COLS:].any()
                        or o[..., MLA_V_COLS:].any()):
                    fail(f"flash_attention_bwd ({r}) {label}: the output or "
                         f"dv is not exactly 0 past column {MLA_V_COLS}")
                del got, again, want
            if label == "train global" and dt_name == "bfloat16":
                train["args"] = (q, k, v, o, do, kw)
    if cross is None:
        fail(f"flash_attention_bwd {CROSS_LABEL}: the sm90 route did not run")
    # the autograd path: ops.mha under grad launches the sm90 route once
    q, k, v, o, do, kw = train["args"]
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    before = k_bwd.launches, k_bwd.route_counts()
    out = ops.mha(qa, ka, va, causal=True, softcap=50.0)
    out.backward(do)
    direct = k_bwd.flash_attention_bwd(q, k, v, out.detach(), do, **kw)
    after = k_bwd.route_counts()
    if k_bwd.launches != before[0] + 2 \
            or after["sm90"] != before[1]["sm90"] + 2 \
            or after["simt"] != before[1]["simt"] or not all(
                torch.equal(a.grad, g) for a, g in zip((qa, ka, va), direct)):
        fail("ops.mha's autograd backward did not launch the sm90 route "
             "once, or its gradients are not the direct call's")
    del qa, ka, va, out, direct
    # controls at the training shape (bf16), each route against its own
    # plain version with a mask moved by a tile: must exceed the limit
    limit = FLASH_BWD_TOL["bfloat16"]
    pkw = dict(causal=True, softcap=50.0)
    controls = []
    for r in k_bwd.ROUTES:
        got = train[r].pop("got")
        for what, moved in (("causal edge a tile later",
                             dict(q_offset=BWD_TILE)),
                            ("window a tile wide", dict(window=BWD_TILE))):
            e = max(grad_errs(got, bwd_plain(r, q, k, v, o, do,
                                             {**pkw, **moved})))
            if not e > limit:
                fail(f"flash_attention_bwd ({r}) control ({what}): {e:.3g} "
                     f"<= {limit}: the gate does not see it")
            controls.append(f"{r} {what} {e:.3g}")
    log(f"flash_attention_bwd: {runs} (case, dtype) runs a route within "
        f"{FLASH_BWD_TOL} of each gradient's max |value| of the route's "
        "plain version (ref.mha_bwd_ref; p_dtype bf16 for sm90); worst "
        + ", ".join(f"{d} {e:.3g}" for d, e in sorted(worst.items()))
        + "; two launches bitwise; default route sm90 for bf16 at every hd "
        "(a multiple of 8), simt for float32; at each padded hd the sm90 "
        "gradients in sentinel-filled buffers: tails intact, heads the "
        "wrapper's bits; scale 1/sqrt(HP) controls (must exceed "
        f"{limit:.3g}): " + "; ".join(padded)
        + f"; {CROSS_LABEL} (sm90, bf16): {cross}"
        + f"; the MoE archs' training calls (bf16): dbrx-132b's (H 48, Hkv "
        f"8, hd 128) and {MLA_TRAIN_LABEL} (o and dv exactly 0 past "
        f"column {MLA_V_COLS}), the forward's o there within "
        + ", ".join(f"{e:.3g}" for e in moe_fwd.values())
        + f" <= {FLASH_TOL['bfloat16']} of max |o| of its plain version "
        "(P in bf16, 64-key chunks)"
        + "; ops.mha's autograd backward is the "
        "sm90 route's call; controls (bf16 training shape, must exceed "
        f"{limit:.3g}): " + "; ".join(controls)
        + "; cases: training shapes (B 2, S 2048, H 8, Hkv 4, hd 256, "
        "softcap 50, global and window 4096) and edges (window 300 < S, S "
        "37/257/1000/130/65/16/300/781/600/200/100 off the tiles, hd "
        "8/48/64/72/80/112/128/136/192, non-causal, GQA 1/2/4/8, q_offset, "
        "kv_len, Sq != Skv, rows with no kept key, llama-3.2-vision-11b's "
        "cross-attention)")
    return {"flash_attention_bwd": train}


# deepseek-v3-671b's MLA training call (phase 38): B 2, S 2048, H = Hkv
# 128, q and k at nope 128 + rope 64 = 192 columns, v zero past 128.
MLA_TRAIN_LABEL = "deepseek-v3-671b MLA training, H = Hkv 128, hd 192"

# llama-3.2-vision-11b's cross-attention training call (phase 34): 2048
# queries over the 1601 vision embeddings, H 32, Hkv 8, hd 128,
# non-causal.  1601 = 25 x 64 + 1: the last key tile holds one key.
CROSS_LABEL = "llama cross-attention, Sq 2048 over Skv 1601, GQA 4, hd 128"


def cross_bwd_checks(args_, got, errs) -> str:
    """The sm90 gradients at the cross-attention shape written into
    sentinel-filled buffers (`bwd_canary`), and a control that must fail
    the gate: the plain version with the last key (alone in its tile)
    dropped."""
    q, k, v, o, do, kw = args_
    bwd_canary(CROSS_LABEL, args_, got)
    limit = FLASH_BWD_TOL["bfloat16"]
    skv = k.shape[1]
    pkw = dict(causal=kw["causal"], window=kw["window"],
               softcap=kw["softcap"], q_offset=kw["q_offset"],
               kv_valid_len=skv - 1)
    e = max(grad_errs(got, bwd_plain("sm90", q, k, v, o, do, pkw)))
    if not e > limit:
        fail(f"flash_attention_bwd control {CROSS_LABEL} (the last of "
             f"{skv} keys dropped): {e:.3g} <= {limit}: the gate does not "
             "see it")
    return (f"(dq, dk, dv) {', '.join(f'{x:.3g}' for x in errs)} <= "
            f"{limit:.3g}, tails intact and heads the wrapper's bits, "
            f"control (the last of {skv} keys dropped) {e:.3g}")


def flash_bwd_cost(args_) -> tuple[float, float]:
    """(bytes, operations) of one backward call: q, k, v, o, do read once,
    dq, dk, dv written once; five products of 2 hd operations a kept
    (query, key) pair and head."""
    q, k, v, o, do, kw = args_
    b, sq, h, hd = q.shape
    kv_len = k.shape[1] if kw["kv_len"] is None else kw["kv_len"]
    el = q.element_size()
    nbytes = el * 2 * (3 * q.numel() + 2 * k.numel())
    pairs = kept_pairs(sq, kv_len, kw["causal"], kw["window"],
                       kw["q_offset"])
    return nbytes, 10.0 * hd * pairs * b * h


def compiled_flex(flex_attention):
    """flex_attention under a fresh torch.compile, dynamo's caches reset
    first.  Each yardstick compiles flex_attention at a shape of its own,
    and dynamo's cache of the one function fills: past it a new shape ran
    unfused, 6-30x slower than its own compile on an H100 in the whole
    smoke (phase 12's flex figures at hubert-xlarge's and zamba2-7b's
    shapes, against the same functions driven alone)."""
    import torch
    torch._dynamo.reset()
    return torch.compile(flex_attention)


def flex_bwd_library(args_, dev):
    """The yardstick for the backward, never called by the port:
    flex_attention's backward under torch.compile (the softcap, where there
    is one, as score_mod, the causal mask as a block mask) on the same q,
    k, v and do.  Returns
    (call, what); call is None where it does not compile."""
    import torch
    q, k, v, o, do, kw = args_
    sq, skv = q.shape[1], k.shape[1]
    cap = kw["softcap"]
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def capped(score, b_, h_, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)

        def mask_mod(b_, h_, q_idx, kv_idx):
            return kv_idx <= q_idx

        score_mod = capped if cap else None
        mask = create_block_mask(mask_mod, None, None, sq, skv, device=dev) \
            if kw["causal"] else None
        fa = compiled_flex(flex_attention)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        # the compiled backward frees ("donates") its saved buffers unless
        # told not to, and then runs once: keep them, at the forward's
        # compile and the backward's, to time it again
        from torch._functorch import config as functorch_config
        keep = functorch_config.patch(donated_buffer=False)
        with keep:
            out = fa(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                     enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()

        def call():
            with keep:
                return torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True)
        call()
        return call, "flex_attention's backward under torch.compile"
    except Exception as e:      # a yardstick that does not run is reported
        return None, f"flex_attention: {type(e).__name__}: {str(e)[:200]}"


def flash_bwd_times(info: dict, launches: dict, dev) -> dict:
    """Both backward routes at the training shape (bf16, B 2, S 2048, H 8,
    Hkv 4, hd 256, causal, softcap 50): L2-warm, and L2-cold over three
    distinct inputs in turn (each call reads 67 MB, more than the L2
    holds, so warm and cold differ little), each beside the bound, its
    plain version and flex_attention's compiled backward, with its
    TFLOP/s and share of the bound; `launches` holds each route's count on
    the training run.  Returns the kernels line entry: the sm90 route (the
    training path's) with both routes' figures under `routes`."""
    import itertools
    import torch
    from repro_torch.kernels import flash_attention_bwd as k_bwd
    saved = k_bwd.launches, k_bwd.route_counts()
    q, k, v, o, do, kw = info["args"]
    nbytes, flops = flash_bwd_cost(info["args"])
    bnd, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    sets = [(q, k, v, o, do)] + [tuple(torch.randn_like(t) for t in
                                       (q, k, v, o, do)) for _ in range(2)]
    pkw = dict(causal=kw["causal"], window=kw["window"],
               softcap=kw["softcap"], q_offset=kw["q_offset"],
               kv_valid_len=kw["kv_len"])
    call, what = flex_bwd_library(info["args"], dev)
    l_ms = cuda_ms(call, reps=5, inner=3) if call is not None else None
    routes = {}
    for r in k_bwd.ROUTES:
        reps = dict(reps=11, inner=10) if r == "sm90" else dict(reps=5,
                                                                inner=3)
        warm = cuda_ms(lambda: k_bwd.flash_attention_bwd(
            q, k, v, o, do, route=r, **kw), **reps)
        ring = itertools.cycle(sets)
        cold = cuda_ms(lambda: k_bwd.flash_attention_bwd(
            *next(ring), route=r, **kw), **reps)
        p_ms = cuda_ms(lambda: bwd_plain(r, q, k, v, o, do, pkw), reps=3,
                       inner=1, warmup=1, backlog=False)
        routes[r] = dict(source=BWD_SOURCES[r], launches=launches[r],
                         max_abs_err=info[r]["err"], ms=warm,
                         l2_cold_ms=cold, plain_ms=p_ms, bound_ms=bnd,
                         bound_by=by, library_ms=l_ms,
                         tflops=flops / (warm * 1e-3) / 1e12,
                         bound_share=bnd / warm)
        log(f"phase 12 flash_attention_bwd ({r}) training shape (B 2, S "
            f"2048, H 8, Hkv 4, hd 256, causal, softcap 50, bf16): "
            f"{warm * 1e3:.2f} us L2-warm, {cold * 1e3:.2f} us L2-cold (3 "
            f"inputs in turn), bound {bnd * 1e3:.2f} us by {by} "
            f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; "
            f"{routes[r]['tflops']:.2f} TFLOP/s, {100 * bnd / warm:.1f} % of "
            f"the bound); plain {p_ms * 1e3:.1f} us (p_dtype "
            f"{BWD_P_DTYPE[r]}); library "
            + ("null" if l_ms is None else f"{l_ms * 1e3:.2f} us")
            + f" ({what}); {launches[r]} launches on the training run")
    sm = routes["sm90"]
    # the tail of the sm90 route's ~2 waves (256 blocks a kernel, one an
    # SM): B 4 runs twice the blocks in ~4 waves (its time by kernel is
    # phase 24's profile, TRAIN_PARTS)
    q4, k4, v4, o4, do4 = (torch.cat([t, t]) for t in (q, k, v, o, do))
    b4 = cuda_ms(lambda: k_bwd.flash_attention_bwd(q4, k4, v4, o4, do4,
                                                   **kw), reps=11, inner=5)
    del q4, k4, v4, o4, do4
    sm["b4_ms"] = b4
    log(f"phase 12 flash_attention_bwd (sm90) B 4 (512 blocks a kernel) "
        f"{b4 * 1e3:.2f} us, {b4 / sm['ms']:.3f}x B 2's "
        f"{sm['ms'] * 1e3:.2f} us")
    if l_ms is not None:
        log(f"phase 12 flash_attention_bwd: sm90 {sm['ms'] * 1e3:.2f} us "
            f"against flex_attention's {l_ms * 1e3:.2f} us "
            f"({l_ms / sm['ms']:.2f}x); simt "
            f"{routes['simt']['ms'] / sm['ms']:.1f}x sm90")
    k_bwd.launches = saved[0]       # timing launches are not the path's
    k_bwd.launches_sm90 = saved[1]["sm90"]
    k_bwd.launches_simt = saved[1]["simt"]
    return dict(name="flash_attention_bwd", route="cuda",
                source=sm["source"],
                replaces="none: the port's own gradient of "
                         "src/repro/kernels/flash_attention.py:96 (the "
                         "reference differentiates its jnp mha, "
                         "src/repro/models/attention.py:52)",
                launches=sum(launches.values()),
                max_abs_err=sm["max_abs_err"], ms=sm["ms"],
                plain_ms=sm["plain_ms"], bound_ms=bnd, bound_by=by,
                library_ms=l_ms, l2_cold_ms=sm["l2_cold_ms"], routes=routes)


# The backward's shapes beside gemma2-2b's training shape (bf16, no window,
# no softcap), each an arch's training call: hubert-xlarge's (phase 32; hd
# 80 at 128 columns), zamba2-7b's shared attention (phase 33; hd 112 at
# 128 columns, causal), and llama-3.2-vision-11b's self-attention and its
# cross-attention over the 1601 vision embeddings (phase 34).
# dbrx-132b's (phase 37: GQA 6, hd 128, causal) and deepseek-v3-671b's MLA
# (phase 38: H = Hkv 128, q and k at 192 columns, v zero-padded from 128
# in the model, random here: the time is the same).
# (label, arch, B, Sq, Skv, H, Hkv, hd, causal)
BWD_SHAPES = (
    ("hubert-xlarge training", "hubert-xlarge", 8, 781, 781, 16, 16, 80,
     False),
    ("zamba2-7b training", "zamba2-7b", 2, 2048, 2048, 32, 32, 112, True),
    ("llama-3.2-vision-11b self-attention training", "llama-3.2-vision-11b",
     2, 2048, 2048, 32, 8, 128, True),
    ("llama-3.2-vision-11b cross-attention training",
     "llama-3.2-vision-11b", 2, 2048, 1601, 32, 8, 128, False),
    ("dbrx-132b training", "dbrx-132b", 2, 2048, 2048, 48, 8, 128, True),
    ("deepseek-v3-671b MLA training", "deepseek-v3-671b", 2, 2048, 2048,
     128, 128, 192, True))
# deepseek-v3-671b's v head dim.  MLA's attention call zero-pads v from it
# to q's and k's 192 columns, so o and dO are zero past it too: the work
# the model asks of the call is QK^T (and dQ, dK) at 192 columns and PV
# (dP, dV) at MLA_V_HD.  Phase 12 gives that work's bound beside the bound
# at 192 columns (the kernels' inputs there are random at every column,
# the time the same).
MLA_V_HD = 128


def mla_model_bound(nbytes: float, flops: float, hd: int,
                    backward: bool) -> float:
    """The bound of an MLA call's model work (v, o, dO and dV at MLA_V_HD
    columns) from its (bytes, operations) at hd columns everywhere: half
    the tensors (v and o; v, o, dO and dV) at MLA_V_HD, and PV of the
    forward's two products, dP and dV of the backward's five."""
    part = (hd + MLA_V_HD) / (2 * hd)
    ops = (3 * hd + 2 * MLA_V_HD) / (5 * hd) if backward else part
    return bound_ms(nbytes * part, flops * ops, BF16_FLOP_PER_S)[0]


# The shapes of phase 12 whose flex_attention yardstick (forward or
# backward) the smoke does not compile: each compile took 5-15 s of its
# time limit (the float32 prefill's and the ring decode's together ~35 s
# on an H100).  `launch/flex_times.py` times flex_attention and the
# kernels at every one of them in a run of its own, and PERF.md section 6
# records that run.  The smoke times the kernels at every shape, and
# flex_attention at the served global prefill (the kernels line's library
# time) and at the training shapes.
FLEX_RECORDED = frozenset((
    "prefill local", "decode ring", "decode global",
    "float32 prefill global", "zamba2-7b prefill",
    "zamba2-7b prefill, simt forced",
    "llama cross prefill", "zamba2-7b decode", "llama cross decode",
    "hubert-xlarge encoder", "dbrx-132b prefill", "dbrx-132b decode",
    "deepseek-v3-671b MLA prefill", "hubert-xlarge training",
    "zamba2-7b training", "llama-3.2-vision-11b self-attention training",
    "llama-3.2-vision-11b cross-attention training"))
FLEX_RECORDED_WHAT = ("flex_attention not compiled in this run: "
                      "launch/flex_times.py times it at this shape, PERF.md "
                      "section 6 keeps its time")


def flash_bwd_shape_times(dev, launches: dict) -> dict:
    """Phase 12: the backward at BWD_SHAPES, sm90 L2-warm and L2-cold (3
    inputs in turn), simt forced, the plain version (p_dtype bf16) and
    flex_attention's compiled backward, beside the bound at the real hd
    and the bound of the work the sm90 kernels do at `sm90_width(hd)`;
    and the 192-column kernels at hd 192 against the same call zero-padded
    to 256 columns.  `launches` holds each arch's training run's backward
    routes."""
    import itertools
    import torch
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.kernels import flash_attention_bwd as k_bwd
    saved = k_bwd.launches, k_bwd.route_counts()
    g = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for label, arch, b, s, skv, h, hkv, hd, causal in BWD_SHAPES:
        kw = dict(causal=causal, window=None, softcap=None, q_offset=0,
                  kv_len=None)

        def make():
            q, k, v, do = (torch.randn(b, n_s, n, hd, generator=g,
                                       device=dev, dtype=torch.bfloat16)
                           for n_s, n in ((s, h), (skv, hkv), (skv, hkv),
                                          (s, h)))
            return q, k, v, k_flash.flash_attention(q, k, v, **kw), do
        sets = [make() for _ in range(3)]
        args_ = (*sets[0], kw)
        nbytes, flops = flash_bwd_cost(args_)
        hp = k_flash.sm90_width(hd)
        bnd, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
        padded, _ = bound_ms(nbytes, flops * hp / hd, BF16_FLOP_PER_S)
        warm = cuda_ms(lambda: k_bwd.flash_attention_bwd(*sets[0], **kw),
                       reps=11, inner=5)
        ring = itertools.cycle(sets)
        cold = cuda_ms(lambda: k_bwd.flash_attention_bwd(*next(ring), **kw),
                       reps=11, inner=5)
        simt = cuda_ms(lambda: k_bwd.flash_attention_bwd(
            *sets[0], route="simt", **kw), reps=3, inner=2, warmup=1)
        pkw = dict(causal=causal, window=None, softcap=None, q_offset=0,
                   kv_valid_len=None)
        p_ms = cuda_ms(lambda: bwd_plain("sm90", *sets[0], pkw), reps=3,
                       inner=1, warmup=1, backlog=False)
        call, what = (None, FLEX_RECORDED_WHAT) if label in FLEX_RECORDED \
            else flex_bwd_library(args_, dev)
        l_ms = cuda_ms(call, reps=5, inner=3) if call is not None else None
        out[label] = dict(
            route="sm90", shape=[b, s, skv, h, hkv, hd], causal=causal,
            padded_hd=hp, ms=cold, l2_warm_ms=warm, simt_ms=simt,
            plain_ms=p_ms, bound_ms=bnd, bound_by=by,
            padded_bound_ms=padded, library_ms=l_ms,
            tflops=flops / (cold * 1e-3) / 1e12,
            launches=launches.get(arch))
        model = ""
        if label.startswith("deepseek-v3-671b MLA"):
            mb = mla_model_bound(nbytes, flops, hd, backward=True)
            out[label]["model_bound_ms"] = mb
            model = (f", {mb * 1e3:.2f} us for the model's work (v, o, dO "
                     f"and dV at {MLA_V_HD} columns; "
                     f"{100 * mb / cold:.1f}% of it)")
        log(f"phase 12 flash_attention_bwd {label} (B {b}, Sq {s}, Skv "
            f"{skv}, H {h}, "
            f"Hkv {hkv}, hd {hd}, {'causal' if causal else 'non-causal'}, "
            f"bf16; sm90 at {hp} columns): {cold * 1e3:.2f} us L2-cold (3 "
            f"inputs in turn), {warm * 1e3:.2f} us L2-warm; bound "
            f"{bnd * 1e3:.2f} us by {by} at the real hd ({flops / 1e9:.2f} "
            f"GFLOP, {nbytes / 1e6:.2f} MB; {100 * bnd / cold:.1f}% of the "
            f"bound), {padded * 1e3:.2f} us for the padded work at {hp} "
            f"columns{model}; simt forced {simt * 1e3:.2f} us ({simt / cold:.1f}x "
            f"sm90); plain {p_ms * 1e3:.1f} us (p_dtype bfloat16); library "
            + ("null" if l_ms is None else
               f"{l_ms * 1e3:.2f} us ({l_ms / cold:.2f}x sm90)")
            + f" ({what}); {arch}'s training run launched "
            f"{launches.get(arch)}")
        del sets, args_
    # the 192-column instantiation against padding hd 192 to 256: the same
    # inputs zero-padded to 256 columns, the work a 256-column kernel does
    # at hd 192 (its zero columns read from memory besides)
    b, s, h, hd = 2, 2048, 16, 192
    kw = dict(causal=True, window=None, softcap=None, q_offset=0,
              kv_len=None)
    q, k, v, do = (torch.randn(b, s, h, hd, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    args_ = (q, k, v, k_flash.flash_attention(q, k, v, **kw), do)
    padded = [torch.nn.functional.pad(t, (0, 256 - hd)) for t in args_]
    at192 = cuda_ms(lambda: k_bwd.flash_attention_bwd(*args_, **kw),
                    reps=11, inner=5)
    at256 = cuda_ms(lambda: k_bwd.flash_attention_bwd(*padded, **kw),
                    reps=11, inner=5)
    out["hd 192 at 192 or 256 columns"] = dict(
        shape=[b, s, s, h, h, hd], causal=True, ms=at192, padded_256_ms=at256)
    log(f"phase 12 flash_attention_bwd hd 192 (B {b}, S {s}, H = Hkv {h}, "
        f"causal, bf16): {at192 * 1e3:.2f} us at 192 columns, "
        f"{at256 * 1e3:.2f} us on the inputs zero-padded to 256 "
        f"({at256 / at192:.3f}x)")
    del q, k, v, do, args_, padded
    k_bwd.launches = saved[0]       # timing launches are not the path's
    k_bwd.launches_sm90 = saved[1]["sm90"]
    k_bwd.launches_simt = saved[1]["simt"]
    return out


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


# ----------------------------------------------------------- WKV backward --

# The WKV backward's routes (csrc/rwkv6_bwd_chunked.cu, bf16 at D 64;
# csrc/rwkv6_bwd.cu, all) against their plain versions, by each gradient's
# max |diff| over its max |value|: `ref.wkv_bwd_exact_ref` (the
# token-by-token formulas) everywhere, and `ref.wkv_bwd_ref` (autograd
# through the chunked form, the CPU path) at the model's decays.  In
# float32 (recurrent only) both sum in float32 in other orders: on an H100
# the kernel read at most 4.7e-7 against the exact formulas, so the limit
# is 1e-5.  In bf16 both round each gradient once from float32 sums, so
# they differ by a bf16 ulp of the value (at most 2^-7 of the max, at a
# value just above a power of two); the chunked route's TF32 operands add
# about 2^-11 of a term before that rounding: limit 2^-7 (on an H100 the
# training shape read 3.2e-3 recurrent, 6.3e-3 chunked, a one-ulp flip).  The controls, built from the
# exact plain version, must exceed a limit against it: the state dropped at
# the checkpoint nearest the middle, the bonus left out, and where the
# decays are far from 1 (w ~ 0.7), the decays read one token late (at the
# model's w ~ 0.9975 that shift read only 9.3e-3, too near the limit to
# count as a control).
WKV_BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
WKV_BWD_NAMES = ("dr", "dk", "dv", "dw", "du")
WKV_TRAIN_SHAPE = (2, 2048, 40, 64)     # rwkv6-3b training: B, L, H, D


def wkv_bwd_inputs(gen, dev, b, ell, h, d, dtype, log_w0):
    """r, k, v, do (B, L, H, D) in `dtype` (0.5 N), w = exp(-exp(log_w0 +
    0.5 N)) float32 (w = 1 for log_w0 None), u (H, D) ~ 0.5 N."""
    import torch
    r, k, v, w, u, _ = wkv_inputs(gen, dev, b, ell, h, d, dtype,
                                  -6.0 if log_w0 is None else log_w0, 0.0)
    if log_w0 is None:
        w = torch.ones_like(w)
    do = (0.5 * torch.randn(b, ell, h, d, generator=gen, device=dev)).to(
        dtype)
    return r, k, v, w, u, do


def wkv_bwd_errs(got, want) -> list:
    return [float((g.float() - x.float()).abs().max()
                  / x.float().abs().max().clamp_min(1e-30))
            for g, x in zip(got, want)]


def wkv_bwd_controls(args_, late: bool) -> dict:
    """The exact plain gradient with the state dropped at the checkpoint
    boundary nearest the middle (two independent halves), with the bonus
    left out (u = 0) and, with `late` (decays far enough from 1 that a
    shift shows), with the decays read one token late."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_bwd as k_wb
    r, k, v, w, u, do = args_
    ell = r.shape[1]
    cut = max(k_wb.CKPT_EVERY, ell // 2 // k_wb.CKPT_EVERY * k_wb.CKPT_EVERY)
    a = ref.wkv_bwd_exact_ref(*(t[:, :cut] for t in (r, k, v, w)), u,
                              do[:, :cut])
    b = ref.wkv_bwd_exact_ref(*(t[:, cut:] for t in (r, k, v, w)), u,
                              do[:, cut:])
    dropped = [torch.cat([x, y], 1) for x, y in zip(a[:4], b[:4])] \
        + [a[4] + b[4]]
    out = {"state dropped at a checkpoint": dropped,
           "bonus left out": list(ref.wkv_bwd_exact_ref(
               r, k, v, w, torch.zeros_like(u), do))}
    if late:
        out["decays one token late"] = list(ref.wkv_bwd_exact_ref(
            r, k, v, torch.cat([w[:, :1], w[:, :-1]], 1), u, do))
    return out


def check_wkv_bwd(dev, gen) -> dict:
    """The WKV backward's routes against their plain versions on the card:
    each case on every route that takes it (`chunked`: bf16 at D 64;
    `recurrent`: all), against the exact formulas and, at the model's
    decays, the chunked form's autograd; `chunked` also logged against its
    own factorisation (`wkv_bwd_subchunk_ref`, TF32 operands).  Cases: the
    training shape, L off the checkpoint, the chunk and the sub-chunk, L <
    16, L 1, D 32, float32, and w near 1e-3, 1e-6 and 1 in float32 and in
    bf16; two launches bitwise each; the controls, which must fail the
    gate; `ops.wkv`'s autograd launching the `chunked` route once.
    Returns the training-shape inputs and each route's error there for
    the timing phase."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_bwd as k_wb
    chunk = get_config("rwkv6-3b").rwkv.chunk
    b0, l0, h0, d0 = WKV_TRAIN_SHAPE
    # (label, B, L, H, D, dtype, log_w0 (None: w = 1), against the chunked
    # plain version too, controls)
    cases = [("training shape", b0, l0, h0, d0, "bfloat16", -6.0, True,
              False),
             ("L 203", 2, 203, 3, 64, "bfloat16", -6.0, True, True),
             ("L 203 float32", 2, 203, 3, 64, "float32", -1.0, False, True),
             ("L 100", 2, 100, 8, 64, "bfloat16", -6.0, True, False),
             ("L 5", 2, 5, 3, 64, "float32", -1.0, False, False),
             ("L 1", 1, 1, 2, 64, "bfloat16", -1.0, False, False),
             ("L 13 D 32", 2, 13, 4, 32, "float32", -1.0, False, False),
             ("L 100 D 32 bf16", 2, 100, 8, 32, "bfloat16", -6.0, True,
              False),
             ("w near 1e-3", 1, 160, 3, 64, "float32", 1.9, False, False),
             ("w near 1e-6", 1, 160, 3, 64, "float32", 2.63, False, False),
             ("w = 1", 1, 160, 3, 64, "float32", None, False, False),
             ("w near 1e-3 bf16", 1, 160, 3, 64, "bfloat16", 1.9, False,
              False),
             ("w near 1e-6 bf16", 1, 160, 3, 64, "bfloat16", 2.63, False,
              False),
             ("w = 1 bf16", 1, 160, 3, 64, "bfloat16", None, False, False)]
    worst, controls, served = {}, {}, None
    for label, b, ell, h, d, dt, log_w0, chunked, with_controls in cases:
        args_ = wkv_bwd_inputs(gen, dev, b, ell, h, d, getattr(torch, dt),
                               log_w0)
        exact = ref.wkv_bwd_exact_ref(*args_)
        plain = ref.wkv_bwd_ref(*args_, chunk) if chunked else None
        tol = WKV_BWD_TOL[dt]
        errs_at = {}
        for rt in k_wb.ROUTES:
            if not k_wb.accepts(rt, args_[0].dtype, d):
                continue
            got = k_wb.wkv_bwd(*args_, route=rt)
            again = k_wb.wkv_bwd(*args_, route=rt)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(g).all()) for g in got) \
                    or [g.dtype for g in got] != [args_[0].dtype] * 3 \
                    + [torch.float32] * 2:
                fail(f"rwkv6_bwd ({rt}) {label}: a gradient is not finite "
                     "or of the wrong dtype")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"rwkv6_bwd ({rt}) {label}: two launches differ")
            errs = {"exact": wkv_bwd_errs(got, exact)}
            if plain is not None:
                errs["chunked"] = wkv_bwd_errs(got, plain)
            for yard, e in errs.items():
                if not max(e) <= tol:
                    fail(f"rwkv6_bwd ({rt}) {label}: against the {yard} plain "
                         f"version {dict(zip(WKV_BWD_NAMES, e))} > {tol}")
            worst[f"{label} ({rt})"] = {yard: max(e)
                                        for yard, e in errs.items()}
            if rt == "chunked":         # its own factorisation: logged
                worst[f"{label} ({rt})"]["subchunk"] = max(wkv_bwd_errs(
                    got, ref.wkv_bwd_subchunk_ref(*args_, operands="tf32")))
            errs_at[rt] = max(float((g.float() - x.float()).abs().max())
                              for g, x in zip(got, exact))
            del got, again
        if with_controls:
            for name, bad in wkv_bwd_controls(args_,
                                              late=log_w0 > -6.0).items():
                e = max(wkv_bwd_errs(bad, exact))
                if not e > tol:
                    fail(f"rwkv6_bwd {label}: the control '{name}' passes "
                         f"the gate ({e:.3g} <= {tol})")
                controls[f"{label}: {name}"] = e
        if label == "training shape":
            served = dict(args=args_, err=errs_at)
        del exact, plain
    # ops.wkv under grad on the card: a _WKV node whose backward is one
    # launch of the chunked route, its gradients the wrapper's
    r, k, v, w, u, do = wkv_bwd_inputs(gen, dev, 2, 300, 4, 64,
                                       torch.bfloat16, -6.0)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    before, routes0 = k_wb.launches, k_wb.route_counts()
    out = ops.wkv(*leaves, None, chunk=chunk)
    grads = torch.autograd.grad(out, leaves, do)
    routes1 = k_wb.route_counts()
    if type(out.grad_fn).__name__ != "_WKVBackward" \
            or k_wb.launches != before + 1 \
            or routes1["chunked"] != routes0["chunked"] + 1 \
            or routes1["recurrent"] != routes0["recurrent"]:
        fail("ops.wkv under grad on the card did not take the rwkv6_bwd "
             f"chunked route once: routes {routes0} -> {routes1}")
    if not all(torch.equal(g, x) for g, x in
               zip(grads, k_wb.wkv_bwd(r, k, v, w, u, do, route="chunked"))):
        fail("ops.wkv's gradients on the card are not the kernel's")
    log("rwkv6_bwd: each gradient's max |diff| / max |value| (worst of dr, "
        "dk, dv, dw, du) by case and route against the exact plain version "
        "and, at the model's decays, the chunked form's autograd (both "
        "gated), and for chunked its own factorisation (subchunk, TF32 "
        "operands, logged), two launches bitwise each: "
        + "; ".join(f"{k} " + ", ".join(f"{y} {e:.3g}" for y, e in v.items())
                    for k, v in worst.items())
        + f" (limits {WKV_BWD_TOL}); controls (each above the limit): "
        + "; ".join(f"{k} {e:.3g}" for k, e in controls.items())
        + "; ops.wkv under grad: one chunked launch, the kernel's gradients")
    return {"rwkv6_bwd": served}


def wkv_bwd_cost(args_) -> tuple[float, float]:
    """(bytes, float32 operations) of the gradient, whatever the design:
    r, k, v, do read and dr, dk, dv written in their dtype, w read and dw
    written in float32, u and du; 14 D^2 operations a (token, head): one
    state step and one dS step (3 D^2 each) and four D-long dots a row
    (dr', dk', dv', dw: 8 D^2).  The kernel's second state step (the
    rebuild) and second copy of the dS step are its design's, not the
    function's, and are not counted."""
    r, k, v, w, u, do = args_
    b, ell, h, d = r.shape
    el = r.element_size()
    nbytes = el * 7 * r.numel() + 4 * (2 * w.numel() + 2 * u.numel())
    return nbytes, 14.0 * d * d * b * ell * h


WKV_BWD_SOURCES = {"chunked": "src/repro_torch/csrc/rwkv6_bwd_chunked.cu",
                   "recurrent": "src/repro_torch/csrc/rwkv6_bwd.cu"}


def wkv_bwd_times(info: dict, launches: dict, dev) -> dict:
    """Both WKV backward routes at the rwkv6-3b training shape (bf16, B 2,
    L 2048, H 40, D 64): L2-warm, and L2-cold over three distinct inputs
    in turn (each call moves 231 MB, more than the L2 holds), each beside
    two bounds (the gradient's 14 D^2 operations in float32 on the CUDA
    cores, and at the TF32 rate, the `chunked` route's type: bytes bound
    it there) and its plain version (`chunked`: `wkv_bwd_subchunk_ref`;
    `recurrent`: `wkv_bwd_ref`, autograd through the chunked form, as the
    CPU path runs it); then both routes over lengths 1 to 256, the
    evidence for CHUNKED_MIN_LEN.  No PyTorch call computes this gradient,
    so there is no library time.  `launches` holds each route's count on
    the training run.  Returns the kernels line entry: the chunked route
    (the training path's) with both routes' figures under `routes`."""
    import itertools
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_bwd as k_wb
    saved = k_wb.launches, k_wb.route_counts()
    args_ = info["args"]
    chunk = get_config("rwkv6-3b").rwkv.chunk
    nbytes, flops = wkv_bwd_cost(args_)
    bounds = {"float32": bound_ms(nbytes, flops, FP32_FLOP_PER_S),
              "tf32": bound_ms(nbytes, flops, TF32_FLOP_PER_S)}
    own = {"chunked": "tf32", "recurrent": "float32"}
    plains = {"chunked": (lambda: ref.wkv_bwd_subchunk_ref(
                  *args_, operands="tf32"), "wkv_bwd_subchunk_ref, TF32 "
                  "operands"),
              "recurrent": (lambda: ref.wkv_bwd_ref(*args_, chunk),
                            "wkv_bwd_ref, autograd through the chunked "
                            "form")}
    sets = [args_] + [tuple(t.clone() for t in args_) for _ in range(2)]
    routes = {}
    for rt in k_wb.ROUTES:
        inner = 10 if rt == "chunked" else 5
        warm = cuda_ms(lambda: k_wb.wkv_bwd(*args_, route=rt), reps=11,
                       inner=inner)
        ring = itertools.cycle(sets)
        cold = cuda_ms(lambda: k_wb.wkv_bwd(*next(ring), route=rt), reps=11,
                       inner=inner)
        plain, what = plains[rt]
        p_ms = cuda_ms(plain, reps=3, inner=1, warmup=1, backlog=False)
        bnd, by = bounds[own[rt]]
        routes[rt] = dict(source=WKV_BWD_SOURCES[rt], launches=launches[rt],
                          max_abs_err=info["err"][rt], ms=warm,
                          l2_cold_ms=cold, plain_ms=p_ms, bound_ms=bnd,
                          bound_by=by, bound_float32_ms=bounds["float32"][0],
                          bound_tf32_ms=bounds["tf32"][0], library_ms=None,
                          bound_share=bnd / warm)
        log(f"phase 12 rwkv6_bwd ({rt}) training shape (B 2, L 2048, H 40, D "
            f"64, bf16): {warm * 1e3:.2f} us L2-warm, {cold * 1e3:.2f} us "
            f"L2-cold (3 inputs in turn); bounds: float32 "
            f"{bounds['float32'][0] * 1e3:.2f} us by {bounds['float32'][1]} "
            f"({100 * bounds['float32'][0] / warm:.1f} %), TF32 "
            f"{bounds['tf32'][0] * 1e3:.2f} us by {bounds['tf32'][1]} "
            f"({100 * bounds['tf32'][0] / warm:.1f} %) ({nbytes / 1e6:.1f} MB "
            f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us; {flops / 1e9:.2f} GFLOP"
            f" {flops / FP32_FLOP_PER_S * 1e6:.2f} us at 67, "
            f"{flops / TF32_FLOP_PER_S * 1e6:.2f} us at 495 TFLOP/s); its own"
            f" type's bound {bnd * 1e3:.2f} us ({100 * bnd / warm:.1f} %); "
            f"plain {p_ms * 1e3:.1f} us ({what}); library null (no PyTorch "
            f"call computes the WKV gradient); {launches[rt]} launches on the "
            "training run")
    ch, rc = routes["chunked"], routes["recurrent"]
    log(f"phase 12 rwkv6_bwd: chunked {ch['ms'] * 1e3:.2f} us against "
        f"recurrent {rc['ms'] * 1e3:.2f} us in the same run "
        f"({rc['ms'] / ch['ms']:.2f}x; a quarter of recurrent is "
        f"{rc['ms'] / 4 * 1e3:.2f} us)")
    sweep = []
    for ell in (1, 4, 8, 16, 32, 64, 256):
        a = wkv_bwd_inputs(torch.Generator(device=dev).manual_seed(ell), dev,
                           2, ell, 40, 64, torch.bfloat16, -6.0)
        times = [cuda_ms(lambda rt=rt: k_wb.wkv_bwd(*a, route=rt), reps=11)
                 for rt in ("chunked", "recurrent")]
        sweep.append(f"L {ell} {times[0] * 1e3:.2f} / {times[1] * 1e3:.2f}")
    log("phase 12 rwkv6_bwd chunked / recurrent us by length (B 2, H 40, D "
        f"64, bf16; CHUNKED_MIN_LEN {k_wb.CHUNKED_MIN_LEN}): "
        + ", ".join(sweep))
    k_wb.launches = saved[0]        # timing launches are not the path's
    k_wb.launches_chunked = saved[1]["chunked"]
    k_wb.launches_recurrent = saved[1]["recurrent"]
    return dict(name="rwkv6_bwd", route="cuda", source=ch["source"],
                replaces="none: the port's own gradient of "
                         "src/repro/kernels/rwkv6_scan.py:64 (the reference "
                         "differentiates its jnp _wkv_chunked, "
                         "src/repro/models/rwkv.py:72)",
                launches=sum(launches.values()),
                max_abs_err=ch["max_abs_err"], ms=ch["ms"],
                plain_ms=ch["plain_ms"], bound_ms=ch["bound_ms"],
                bound_by=ch["bound_by"], library_ms=None,
                l2_cold_ms=ch["l2_cold_ms"], bound_share=ch["bound_share"],
                routes=routes)


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
        prep, call, what = (None, None, FLEX_RECORDED_WHAT) \
            if label in FLEX_RECORDED else flex_library((q, k, v, kw), dev)
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
    prep, call, what = (None, None, FLEX_RECORDED_WHAT) \
        if "float32 prefill global" in FLEX_RECORDED \
        else flex_library((q, k, v, kw), dev)
    l_ms = None
    if prep is not None:
        args_ = prep(q, k, v)
        l_ms = cuda_ms(lambda: call(*args_), reps=3, inner=1)
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


def flash_hybrid_times(dev) -> dict:
    """Phase 12 at the hybrid, audio and MoE archs' flash shapes
    (hubert-xlarge's encoder at hd 80, deepseek-v3-671b's MLA prefill at
    192 among them), bf16, on the route the
    wrapper picks (and, at zamba2-7b's prefill, on `simt` forced beside
    it, the route it took before sm90 took hd 112): L2-warm (one input,
    again and again) and L2-cold (the call walks 3 distinct inputs in turn,
    5 at a decode shape, as a pass meets its layers' caches), each with its
    bound (at the real hd, whatever the kernel pads to), and flex_attention
    under torch.compile (its composite where flex does not compile).
    Returns each shape's figures for the kernels line."""
    import itertools
    import torch
    from repro_torch.kernels import flash_attention as k_flash
    # (label, B, Sq, Skv, H, Hkv, hd, causal, kv_len, forced route):
    # zamba2-7b's prefill (hd 112: sm90 at 128 columns; simt forced for
    # the record) and decode over the 5008-slot cache (split);
    # llama-3.2-vision-11b's cross-attention prefill over the 1601 vision
    # keys (sm90) and its decode (split); hubert-xlarge's encoder (sm90 at
    # 128 columns); dbrx-132b's prefill (sm90, GQA 6) and decode (split, 6
    # rows a kv head); deepseek-v3-671b's MLA prefill (sm90 at 192 columns:
    # nope 128 + rope 64; v zero-padded from 128 in the model, random here,
    # the time the same); and the two archs' training calls (phases 37-38,
    # B 2, S TRAIN_SEQ).  FLEX_RECORDED's shapes skip flex_attention.
    shapes = (
        ("zamba2-7b prefill", 2, SERVE_PROMPT, SERVE_PROMPT, 32, 32, 112,
         True, None, None),
        ("zamba2-7b prefill, simt forced", 2, SERVE_PROMPT, SERVE_PROMPT, 32,
         32, 112, True, None, "simt"),
        ("llama cross prefill", 2, SERVE_PROMPT, 1601, 32, 8, 128, False,
         None, None),
        ("zamba2-7b decode", 2, 1, SERVE_PROMPT + DENSE_GEN, 32, 32, 112,
         False, SERVE_PROMPT + 1, None),
        ("llama cross decode", 2, 1, 1601, 32, 8, 128, False, None, None),
        ("hubert-xlarge encoder", ENCODER_BATCH, ENCODER_SEQ, ENCODER_SEQ,
         16, 16, 80, False, None, None),
        ("dbrx-132b prefill", 2, SERVE_PROMPT, SERVE_PROMPT, 48, 8, 128,
         True, None, None),
        ("dbrx-132b decode", 2, 1, SERVE_PROMPT + DENSE_GEN, 48, 8, 128,
         False, SERVE_PROMPT + 1, None),
        ("deepseek-v3-671b MLA prefill", 2, SERVE_PROMPT, SERVE_PROMPT, 128,
         128, 192, True, None, None),
        ("dbrx-132b training", 2, TRAIN_SEQ, TRAIN_SEQ, 48, 8, 128, True,
         None, None),
        ("deepseek-v3-671b MLA training", 2, TRAIN_SEQ, TRAIN_SEQ, 128, 128,
         192, True, None, None))
    saved = k_flash.launches, k_flash.route_counts()
    g = torch.Generator(device=dev).manual_seed(11)
    out, libs = {}, {}
    for label, b, sq, skv, h, hkv, hd, causal, kvl, forced in shapes:
        cold = 3 if sq > 1 else 5

        def make():
            return (torch.randn(b, sq, h, hd, generator=g, device=dev,
                                dtype=torch.bfloat16),
                    torch.randn(b, skv, hkv, hd, generator=g, device=dev,
                                dtype=torch.bfloat16),
                    torch.randn(b, skv, hkv, hd, generator=g, device=dev,
                                dtype=torch.bfloat16))
        inputs = [make() for _ in range(cold)]
        kw = dict(causal=causal, window=None, softcap=None, q_offset=0,
                  kv_len=kvl)
        q, k, v = inputs[0]
        spec = kernel_spec("flash_attention", (q, k, v, kw), dev)
        bnd, by = bound_ms(spec["nbytes"], spec["flops"], spec["rate"])
        route = forced or k_flash.route(q.dtype, b, sq, skv, h, hkv, hd,
                                        skv if kvl is None else kvl)
        reps, inner = (3, 3) if sq > 1 else (21, 10)
        warm = cuda_ms(lambda: k_flash.flash_attention(q, k, v, route=route,
                                                       **kw),
                       reps=reps, inner=inner)
        ring = itertools.cycle(inputs)
        cold_ms = cuda_ms(lambda: k_flash.flash_attention(
            *next(ring), route=route, **kw), reps=reps, inner=inner)
        # the library call once a shape, not again for a forced route
        key = (b, sq, skv, h, hkv, hd, causal, kvl)
        if label in FLEX_RECORDED:
            libs[key] = None, FLEX_RECORDED_WHAT
        if key not in libs:
            l_ms = None
            prep, call, what = flex_library((q, k, v, kw), dev)
            if prep is not None:
                args_ = prep(q, k, v)
                l_ms = cuda_ms(lambda: call(*args_), reps=reps, inner=inner)
            libs[key] = l_ms, what
        l_ms, what = libs[key]
        out[label] = dict(route=route, source=FLASH_SOURCES[route],
                          shape=[b, sq, skv, h, hkv, hd], causal=causal,
                          ms=cold_ms, l2_warm_ms=warm, bound_ms=bnd,
                          bound_by=by, library_ms=l_ms)
        if route == "sm90":
            hp = k_flash.sm90_width(hd)
            out[label]["padded_hd"] = hp
            out[label]["padded_bound_ms"] = bound_ms(
                spec["nbytes"], spec["flops"] * hp / hd, spec["rate"])[0]
        mask = "causal" if causal else "non-causal"
        pad = (f", computed at {k_flash.sm90_width(hd)} columns: the "
               "padded work's bound "
               f"{out[label]['padded_bound_ms'] * 1e3:.2f} us"
               if route == "sm90" and k_flash.sm90_width(hd) != hd else "")
        if label.startswith("deepseek-v3-671b MLA"):
            mb = mla_model_bound(spec["nbytes"], spec["flops"], hd,
                                 backward=False)
            out[label]["model_bound_ms"] = mb
            pad += (f"; the model's work (v and o at {MLA_V_HD} columns) "
                    f"bound {mb * 1e3:.2f} us, {100 * mb / cold_ms:.1f}% of "
                    "it")
        log(f"phase 12 flash_attention {label} (B {b}, Sq {sq}, Skv {skv}, "
            f"H {h}, Hkv {hkv}, hd {hd}, {mask}, bf16; {route}{pad}): "
            f"{cold_ms * 1e3:.2f} us L2-cold over {cold} "
            f"inputs, {warm * 1e3:.2f} us L2-warm, bound {bnd * 1e3:.2f} us "
            f"by {by} at the real hd ({spec['flops'] / 1e9:.2f} GFLOP, "
            f"{spec['nbytes'] / 1e6:.2f} MB; {100 * bnd / cold_ms:.1f}% of "
            "the bound); library "
            + ("null" if l_ms is None else f"{l_ms * 1e3:.2f} us, "
               f"{l_ms / cold_ms:.3g}x the route's L2-cold time")
            + f" ({what})")
        del inputs, q, k, v
    k_flash.launches = saved[0]
    k_flash.launches_sm90, k_flash.launches_split, k_flash.launches_simt = (
        saved[1]["sm90"], saved[1]["split"], saved[1]["simt"])
    return out


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
    softcap (where there is one) as a score_mod and the masks (causal,
    window, q_offset, kv_len) as a block mask; where it does not compile
    (a decode's single query row), the bf16 composite softmax(cap tanh(q
    k^T scale / cap)) v over the kv_len valid keys.  Returns (prep, call,
    what): prep(q, k, v) gives call's arguments (layout changes, outside
    any timing), and call(...) the output in flex's layout; what names
    the yardstick and its max |diff| against the plain version.  (None,
    None, reason) if neither runs."""
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
        if cap is None:
            score_mod = None

        def mask_mod(b_, h_, q_idx, kv_idx):
            keep = kv_idx < kvl
            if causal:
                keep = keep & (kv_idx <= q_idx + qo)
            if window:
                keep = keep & (kv_idx > q_idx + qo - window)
            return keep

        mask = create_block_mask(mask_mod, None, None, sq, skv, device=dev)
        fa = compiled_flex(flex_attention)

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
        if cap is not None:
            x = cap * torch.tanh(x / cap)
        return (torch.softmax(x.float(), dim=-1).to(qg.dtype) @ vt).reshape(
            b, h, 1, hd)
    err = diff(call(*prep(q, k, v)))
    return prep, call, f"composite softmax(cap tanh(q k^T scale / cap)) v in "\
        f"bf16 (flex did not compile: {why}), max |diff| {err:.3g}"


# ---------------------------------------------------------- phases 10-11 --

def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def serve_profile(fn, label: str, parts: dict, phase: int,
                  ranges: dict | None = None) -> dict:
    """Device time by kernel of fn() from torch.profiler's CUDA activity,
    and the share of each part: `parts` maps a label to the substrings of
    the CUDA kernel names that make it up, `ranges` a label to the
    (module, name) of a port function that fn() runs in a profiler range
    of its name (`profile_ranges`), whose kernels' device time it
    counts.  Returns {"device_ms": total, part: {"ms",
    "share"}, "top": [[kernel, ms, count], ...]}, or {"device_ms": "not
    measured"} where the profiler cannot trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ranges = ranges or {}
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
    except RuntimeError as e:       # no CUPTI tracing on this machine
        log(f"phase {phase} {label} device time by kernel: not measured "
            f"({e})")
        return {"device_ms": "not measured"}
    events = prof.key_averages()
    # a range may also show as a device-side annotation: not a kernel
    rows = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == DeviceType.CUDA
            and e.key not in {n for _, n in ranges.values()}]
    rows.sort(key=lambda r: -r[1])
    total = sum(t for _, t, _ in rows)
    out = {"device_ms": total / 1e3}
    for part, names in parts.items():
        t = sum(t for k, t, _ in rows if any(n in k for n in names))
        out[part] = {"ms": t / 1e3, "share": t / max(total, 1e-9)}
    for part, (_, name) in ranges.items():
        t = sum(e.device_time_total for e in events
                if e.key == name and e.device_type == DeviceType.CPU)
        out[part] = {"ms": t / 1e3, "share": t / max(total, 1e-9)}
    out["top"] = [[k[:60], t / 1e3, n] for k, t, n in rows[:8]]
    log(f"phase {phase} {label} device time {total / 1e3:.1f} ms, of which "
        + ", ".join(f"{part} {v['ms']:.1f} ms ({100 * v['share']:.1f}%)"
                    for part, v in out.items()
                    if part in parts or part in ranges)
        + ", torch.profiler; top: "
        + "; ".join(f"{k[:50]} {t / 1e3:.1f} ms x{n}" for k, t, n in rows[:8]))
    return out


def wkv_sequential_inplace(r, k, v, w, u, state, *, chunk: int):
    """`ops.wkv`'s contract through the sequential plain recurrence
    (`ref.wkv_ref`): a second plain version of the WKV, for the bf16
    noise yardstick of the rwkv6-3b serve."""
    from repro_torch.kernels import ref
    out, s = ref.wkv_ref(r, k, v, w, u, state)
    state.copy_(s)
    return out.to(r.dtype)


# The plain attentions' float32 scores a block stay under this many bytes:
# deepseek-v3-671b's 128 heads at S 5000 would otherwise take 5.2 GB a
# block, several at a time, beside 54.6 GB of weights (at 2e9 its phase
# peaked at 68.70 GB on an H100 80GB HBM3).
PLAIN_BLOCK_BYTES = 1e9


def plain_rows(b: int, h: int, skv: int, rows: int = 1024) -> int:
    """The query rows (or keys) a block of a plain attention takes: at
    most `rows`, fewer where a block's (B, H, rows, Skv) float32 scores
    would pass PLAIN_BLOCK_BYTES (781 at a 32-head prefill of 5000, 195 at
    deepseek-v3-671b's 128 heads; a row's result does not depend on its
    block)."""
    return max(1, min(rows, int(PLAIN_BLOCK_BYTES // (4 * b * h * skv))))


def mha_dense_plain(q, k, v, *, causal: bool, window=None, softcap=None,
                    q_offset: int = 0, kv_valid_len=None, kv_chunk=1024):
    """`ops.mha`'s contract through the dense softmax with an explicit
    keep mask (`masked_attention`): a second plain version of the
    attention, for the bf16 noise yardstick of the hybrid and MoE
    serves."""
    keep = keep_mask(q.shape[1], k.shape[1], causal, window, q_offset,
                     kv_valid_len, q.device)
    return masked_attention(q, k, v, keep, softcap, rows=plain_rows(
        q.shape[0], q.shape[2], k.shape[1]))


def mha_ref_lean(q, k, v, *, kv_chunk: int = 1024, **kw):
    """`ref.mha_ref` with its key chunk cut by `plain_rows` (195 at
    deepseek-v3-671b's prefill): the same online softmax, its chunks'
    float32 scores under PLAIN_BLOCK_BYTES."""
    from repro_torch.kernels import ref
    return ref.mha_ref(q, k, v, kv_chunk=plain_rows(
        q.shape[0], q.shape[2], q.shape[1], kv_chunk), **kw)


# Each served arch: its kernel, the `ops` function that reaches it, that
# function's plain version (a name in `ref`, or a function here), a second
# plain version (the bf16 noise yardstick, or None), and the phases of its
# bf16 and float32 runs.
SERVED = {"gemma2-2b": ("flash_attention", "mha", "mha_ref", None,
                        (10, 11)),
          "rwkv6-3b": ("rwkv6_scan", "wkv", "wkv_inplace_ref",
                       wkv_sequential_inplace, (13, 14)),
          "granite-8b": ("flash_attention", "mha", "mha_ref", None,
                         (26, 26)),
          "nemotron-4-15b": ("flash_attention", "mha", "mha_ref", None,
                             (27, 27)),
          "gemma3-12b": ("flash_attention", "mha", "mha_ref", None,
                         (28, 28)),
          "zamba2-7b": ("flash_attention", "mha", "mha_ref", mha_dense_plain,
                        (29, 29)),
          "llama-3.2-vision-11b": ("flash_attention", "mha", "mha_ref",
                                   mha_dense_plain, (30, 30)),
          "dbrx-132b": ("flash_attention", "mha", "mha_ref", mha_dense_plain,
                        (35, 35)),
          "deepseek-v3-671b": ("flash_attention", "mha", mha_ref_lean,
                               mha_dense_plain, (36, 36))}
# The dense archs served at their published widths beside gemma2-2b
# (configs/granite_8b.py: 36 layers, d_model 4096, 32 heads, GQA kv 8, hd
# 128, SwiGLU, RMSNorm, untied, 8254.7M parameters; nemotron_4_15b.py: 32
# layers, d_model 6144, 48 heads, kv 8, hd 128, squared ReLU, LayerNorm,
# untied vocab 256000, 15628.8M; gemma3_12b.py: 48 layers = 8 x (5 local
# with window 1024 + 1 global), d_model 3840, 16 heads, kv 8, hd 256,
# qk-norm, GeGLU, tied vocab 262144, 11765.4M), bf16, random weights from
# --seed, at gemma2's batch and prompt.
DENSE_ARCHS = ("granite-8b", "nemotron-4-15b", "gemma3-12b")
# The hybrid and vision archs served the same way (configs/zamba2_7b.py:
# 81 layers = 13 x (5 mamba + 1 shared_attn) + 3 mamba, d_model 3584, one
# weight-tied attention block of 32 heads, kv 32, hd 112 with rank-64 LoRA
# at each of its 13 invocations, GeGLU d_ff 14336, Mamba-2 state 64, heads
# of 64, expand 2, chunk 128, vocab 32000, 5749.4M parameters;
# llama_3_2_vision_11b.py: 40 layers = 8 x (4 attn + 1 cross), d_model
# 4096, 32 heads, kv 8, hd 128, SwiGLU, vocab 128256, rope theta 5e5, gated
# cross-attention over 1601 stub vision embeddings, 10110.7M).  Their
# zero-initialized leaves (the cross gates, the LoRA b matrices) and the
# SSD's constants (A_log 0, D 1, dt_bias 0) would leave whole paths inert,
# so both phases draw them from --seed first (`wake_inert_leaves`).
HYBRID_ARCHS = ("zamba2-7b", "llama-3.2-vision-11b")
# The MoE archs, served at every published width with their depth cut to
# SERVE_PERIODS repeats of the period (the serve driver's --periods), the
# most under ~70 GB of peak with the plain run
# (configs/dbrx_132b.py: 40 moe layers, d_model 6144, 48 heads, kv 8, hd
# 128, 16 experts top-4 of d_expert 10752, SwiGLU, vocab 100352, rope
# theta 5e5, 131596.5M parameters, 6.52 GB a layer in bf16: 8 layers and
# the untied embeddings are 54.6 GB; deepseek_v3_671b.py: 3 dense MLA
# layers (d_ff 18432) and 58 moe ones, d_model 7168, 128 heads, MLA q_lora
# 1536, kv_lora 512, nope 128 + rope 64 (qk hd 192), v 128, 256 routed
# experts top-8 of 2048 and one shared, vocab 129280, the MTP leaves,
# 671712.7M parameters: the 3 dense layers and 2 of the 58 moe ones are
# 54.6 GB).
MOE_ARCHS = ("dbrx-132b", "deepseek-v3-671b")
SERVE_PERIODS = {"dbrx-132b": 8, "deepseek-v3-671b": 2}
# Their greedy decode steps: 8, not 32, to keep the whole smoke near 900 s
# (with 32 it took 880.8 s from phase 1 on an H100 80GB HBM3 at 700 W);
# 8 still decodes past every local layer's 1024-slot ring.
DENSE_GEN = 8
SERVE_GENS = {"gemma2-2b": SERVE_GEN, "rwkv6-3b": SERVE_GEN,
              **{a: DENSE_GEN for a in DENSE_ARCHS + HYBRID_ARCHS
                 + MOE_ARCHS}}
# The CUDA kernels of each arch's kernel module, by the substrings of
# their names in a profile: flash attention's three routes, the WKV's two;
# for the hybrid and MoE archs also cuBLAS's matmuls, and (by a profiler
# range around each call of a port function, by module and name) the
# mamba mixers and their chunked SSD, the MoE FFN and the absorbed MLA
# decode.
FLASH_PARTS = {"flash sm90": ("flash_sm90_kernel",),
               "flash split": ("flash_decode_kernel",
                               "flash_decode_combine"),
               "flash simt": ("flash_attention_kernel",)}
CUBLAS_PARTS = {"cuBLAS": ("gemm", "nvjet", "cutlass", "xmma", "cublas")}
PROFILE_PARTS = {
    "gemma2-2b": FLASH_PARTS,
    "rwkv6-3b": {"wkv chunked": ("rwkv6_chunked_kernel",),
                 "wkv recurrent": ("rwkv6_scan_kernel",)},
    **{a: FLASH_PARTS for a in DENSE_ARCHS},
    **{a: {**FLASH_PARTS, **CUBLAS_PARTS} for a in HYBRID_ARCHS + MOE_ARCHS}}
PROFILE_RANGES = {"zamba2-7b": {"mamba mixer": ("ssm", "mamba_forward"),
                                "SSD": ("ssm", "_ssd_chunked")},
                  "dbrx-132b": {"MoE": ("moe", "moe_apply")},
                  "deepseek-v3-671b": {"MoE": ("moe", "moe_apply"),
                                       "MLA decode": ("attention",
                                                      "mla_decode")},
                  "granite-8b int8": {"quantize": ("attention",
                                                   "quantize_kv"),
                                      "dequantize": ("attention",
                                                     "dequantize_kv")}}
# The routes a served bf16 run must take, (every prefill call's, every
# decode call's), each route's launches `pass_launches` of a prefill and
# of a decode step, every other route none: gemma2-2b sm90 and split;
# rwkv6-3b's WKV chunked and recurrent; zamba2-7b's hd 112 runs on sm90 at
# 128 columns (the 16 past hd zero-filled) and deepseek-v3-671b's MLA
# prefill at 192 (qk hd 192, v zero-padded from 128; no decode call), so
# no bf16 call of any attention arch takes simt.  Each arch's float32
# prefill takes SERVE_F32_ROUTE.
SERVE_ROUTES = {a: ("sm90", "split") for a in ("gemma2-2b",) + DENSE_ARCHS
                + HYBRID_ARCHS + MOE_ARCHS}
SERVE_ROUTES["rwkv6-3b"] = ("chunked", "recurrent")
SERVE_F32_ROUTE = {"gemma2-2b": "simt", "rwkv6-3b": "recurrent",
                   **{a: "simt" for a in DENSE_ARCHS + HYBRID_ARCHS
                      + MOE_ARCHS}}
# The reduced config of a hybrid or MoE arch (float32; the SSD, the routed
# MoE and the absorbed MLA decode in plain PyTorch) on the card against the
# port's CPU run of the same weights: prefill logits, every cache leaf and
# DENSE_GEN teacher-forced decode steps, by max |diff| over max |value| (no
# kernel covers the SSD, the MoE or the MLA decode, so this is their card
# gate).
CARD_CPU_PROMPT = 200
CARD_CPU_RTOL = 1e-4
# An int8 cache's decode logits where some int8 value of the card's cache
# is a step from the CPU's (the card's float32 k an ulp from a .5 boundary
# of k / scale): one such value moved reduced granite-8b's decode logits
# by 1.94e-4 of their scale on an H100, past CARD_CPU_RTOL.  The prefill
# logits and the float leaves stay at CARD_CPU_RTOL, and so does the
# decode where no int8 value is apart.
INT8_APART_DECODE_RTOL = 1e-3
# The float32 prefill copies the served weights to float32 leaf by leaf
# after the bf16 model is dropped; where all the float32 weights would pass
# F32_WEIGHTS_BYTES (nemotron-4-15b's are 62.5 GB of the card's 80) it runs
# the first layers that fit, and says so.
F32_WEIGHTS_BYTES = 48e9


def float32_model(tree: dict, cfg):
    """The weights of `tree` (the only reference to them: the caller has
    dropped its model) in float32, each leaf cast as its bf16 one is
    released.  Where the float32 weights of all would pass
    F32_WEIGHTS_BYTES, it keeps the model's scan groups in order while
    they fit, cuts the last group it keeps to the periods of it that fit
    (none where not one fits), and drops the groups after it (their bf16
    leaves released first); every leaf outside the groups is kept.
    Returns (LM, its config, the periods kept of each group by name, the
    float32 bytes of all)."""
    import torch
    from repro_torch.models import LM
    from repro_torch.models.transformer import scan_groups
    groups = scan_groups(cfg)

    def leaves(node, pre=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{pre}{k}.")
            else:
                yield pre + k, v

    sizes = {k: v.numel() for k, v in leaves(tree)}
    full = 4 * sum(sizes.values())
    group_bytes = [4 * sum(n for k, n in sizes.items()
                           if k.startswith(f"group{gi}."))
                   for gi in range(len(groups))]
    room = F32_WEIGHTS_BYTES - (full - sum(group_bytes))
    keep = {}
    for gi, g in enumerate(groups):
        fits = g.n if full <= F32_WEIGHTS_BYTES else max(
            0, min(g.n, int(room // (group_bytes[gi] / g.n))))
        keep[f"group{gi}"] = fits
        room -= fits * group_bytes[gi] / g.n
        if fits < g.n:           # the groups after a cut one are dropped
            room = 0
    for name, n in keep.items():
        if n == 0:
            del tree[name]       # releases its bf16 leaves before any cast

    def cast(node, cut):
        for k in list(node):
            if isinstance(node[k], dict):
                cast(node[k], keep.get(k) if cut is None else cut)
            else:      # replacing the entry releases the bf16 leaf
                leaf = node[k].detach()
                node[k] = (leaf if cut is None else leaf[:cut]).to(
                    torch.float32)

    cast(tree, None)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if any(keep[f"group{gi}"] < g.n for gi, g in enumerate(groups)):
        # the groups in order: the head blocks, the period, the tail
        # blocks (a run of one kind is one group of its length, a mixed
        # run one group of one)
        order = iter(range(len(groups)))

        def kept(blocks):
            if not blocks:
                return ()
            gi = next(order)
            return blocks[:len(blocks) * keep[f"group{gi}"] // groups[gi].n]

        head = kept(cfg.head_blocks)
        periods = keep[f"group{next(order)}"] if cfg.num_periods else 0
        tail = kept(cfg.tail_blocks)
        cfg32 = dataclasses.replace(
            cfg32, head_blocks=head, num_periods=periods, tail_blocks=tail,
            num_layers=len(head) + len(cfg.period) * periods + len(tail))
    return LM(cfg32, tree), cfg32, keep, full


# The flash launches of a served pass, by block kind: one an attention
# call (a shared_attn invocation among them), two a cross layer (its
# self-attention and its cross-attention), one a moe block's attention; an
# rwkv block one WKV; a mamba block none.  With MLA an attention block
# launches in prefill only: the absorbed decode is plain PyTorch.
PASS_LAUNCHES = {"rwkv": 1, "attn": 1, "local": 1, "global": 1,
                 "shared_attn": 1, "cross": 2, "moe": 1}


def pass_launches(cfg, decode: bool = False) -> int:
    """Launches of the served kernel in a prefill of `cfg`, or with
    `decode` in a decode step, by PASS_LAUNCHES."""
    if decode and cfg.mla is not None:
        return 0
    return sum(PASS_LAUNCHES.get(k, 0) for k in cfg.layer_kinds)


def train_launches(cfg) -> tuple[int, int]:
    """(forwards, backwards) of the trained kernel in one train step of
    `cfg` under remat: each call of a pass runs forward twice (the
    recompute) and backward once; an MTP model's MTP block, an attention
    block outside remat, once each."""
    n, mtp = pass_launches(cfg), int(bool(cfg.mtp))
    return 2 * n + mtp, n + mtp


def train_depth_cut(cfg, periods: int):
    """`cfg` with `periods` repeats of its period, its head and tail blocks
    and every width kept (the serve driver's `--periods`)."""
    from repro_torch.launch.serve import depth_cut
    return depth_cut(cfg, periods)


INERT_DRAWS = {"gate": ("uniform", 0.5, 1.5), "lora_q_b": ("normal", 0.02),
               "lora_o_b": ("normal", 0.02), "A_log": ("uniform", -1.0, 1.0),
               "dt_bias": ("uniform", -2.0, 0.0), "D": ("uniform", 0.5, 1.5),
               "conv_b": ("normal", 0.1), "mask_emb": ("normal", 0.5)}


def wake_inert_leaves(model, seed: int) -> list:
    """Draw the leaves that the reference's init leaves inert (the cross
    gates 0, the LoRA b matrices 0, the SSD's A_log 0, D 1, dt_bias 0 and
    conv bias 0, an audio model's mask_emb 0) from a generator seeded by
    `seed`, in place: gate U(0.5, 1.5), LoRA b 0.02 N, A_log U(-1, 1),
    dt_bias U(-2, 0), D U(0.5, 1.5), conv_b 0.1 N, mask_emb 0.5 N.
    Returns the paths drawn."""
    import torch
    gen = torch.Generator(device=model.device).manual_seed(seed + 5)
    drawn = []
    with torch.no_grad():
        for path, leaf in model.named_parameters():
            how = INERT_DRAWS.get(path.rsplit(".", 1)[-1])
            if how is None:
                continue
            t = torch.empty(leaf.shape, dtype=torch.float32,
                            device=leaf.device)
            if how[0] == "uniform":
                t.uniform_(how[1], how[2], generator=gen)
            else:
                t.normal_(0.0, how[1], generator=gen)
            leaf.copy_(t)
            drawn.append(path)
    return drawn


def vision_input(cfg, b: int, seed: int, dev):
    """The stub vision embeddings of a vlm (`serve.make_vision_embeds`) on
    the card in the model's dtype; None for any other config."""
    import torch
    from repro_torch.launch import serve
    vis = serve.make_vision_embeds(cfg, b, seed)
    return None if vis is None else torch.as_tensor(vis, device=dev).to(
        getattr(torch, cfg.dtype))


def card_cpu_phase(arch: str, seed: int, dev, ph: int,
                   kv_cache_dtype: str = "model") -> dict:
    """The reduced config of `arch` (float32, with `kv_cache_dtype`) with
    the same weights on the card and on the CPU, woken as the full-width
    run's: prefill logits at CARD_CPU_PROMPT tokens, every cache leaf
    (KVCache, SSMState, CrossKV, MLACache), and DENSE_GEN decode steps
    teacher-forced by the CPU run's tokens, each by max |diff| over max
    |value| <= CARD_CPU_RTOL; an int8 cache's values (the leaves with a
    scale) at most one step apart, the differing ones counted (a card's
    float32 k an ulp from a .5 boundary rounds apart), and where any is
    apart the decode logits at INT8_APART_DECODE_RTOL."""
    import torch
    from repro_torch.interop import kv_cache_to_numpy
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import LM, init_params
    cfg = dataclasses.replace(serve.serve_config(arch, reduced=True),
                              kv_cache_dtype=kv_cache_dtype)
    cpu_model = init_params(cfg, seed=seed, device="cpu")
    wake_inert_leaves(cpu_model, seed)
    card_model = LM(cfg, _to_device(cpu_model.tree(), dev))
    p, g = CARD_CPU_PROMPT, DENSE_GEN
    prompts = torch.as_tensor(serve.make_prompts(cfg, 2, p + g, seed))
    vis = serve.make_vision_embeds(cfg, 2, seed)
    runs = {}
    for name, model, d in (("cpu", cpu_model, torch.device("cpu")),
                           ("card", card_model, dev)):
        prefill = make_prefill_step(cfg, s_max=p + g)
        decode = make_decode_step(cfg)
        lg, cache = prefill(model, prompts[:, :p].to(d),
                            None if vis is None else torch.as_tensor(
                                vis, device=d))
        logits = [lg.cpu()]
        for i in range(g):
            lg, cache = decode(model, cache, prompts[:, p + i:p + i + 1].to(d),
                               p + i)
            logits.append(lg.cpu())
        runs[name] = (logits, kv_cache_to_numpy(cache))
    (lc, cc), (lk, ck) = runs["cpu"], runs["card"]
    errs = [rel_err(a, b) for a, b in zip(lk, lc)]
    quant = {k for k in cc if f"{k}_scale" in cc}
    leaf_errs = {k: float(np.abs(ck[k] - cc[k]).max()
                          / max(np.abs(cc[k]).max(), 1e-30))
                 for k in cc if k not in quant}
    worst_leaf = max(leaf_errs, key=leaf_errs.get)
    apart = sum(int((ck[k] != cc[k]).sum()) for k in quant)
    steps = max((float(np.abs(ck[k] - cc[k]).max()) for k in quant),
                default=0.0)
    dtol = INT8_APART_DECODE_RTOL if apart else CARD_CPU_RTOL
    if set(ck) != set(cc) or not errs[0] <= CARD_CPU_RTOL \
            or not max(errs[1:]) <= dtol \
            or not leaf_errs[worst_leaf] <= CARD_CPU_RTOL or steps > 1:
        fail(f"{arch} reduced card vs CPU: logits prefill {errs[0]:.3g}, "
             f"worst cache leaf {worst_leaf} {leaf_errs[worst_leaf]:.3g} "
             f"(<= {CARD_CPU_RTOL}?), decode {max(errs[1:]):.3g} (<= "
             f"{dtol}?), int8 values {steps:g} steps apart (<= 1?)")
    n_quant = sum(cc[k].size for k in quant)
    int8_text = (f"; {apart} of {n_quant} int8 values differ, by at most "
                 f"{steps:g} step" if quant else "")
    log(f"phase {ph} {arch} reduced ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, float32, {kv_cache_dtype} KV cache, TF32 off) card "
        f"vs the port's CPU run of the same weights, B 2 prompt {p} + {g} "
        f"teacher-forced decode steps: logits prefill {errs[0]:.3g}, decode "
        f"{max(errs[1:]):.3g} (<= {dtol}), {len(cc)} cache leaves at the "
        f"end, worst {'float ' if quant else ''}{worst_leaf} "
        f"{leaf_errs[worst_leaf]:.3g}, prefill and leaves <= "
        f"{CARD_CPU_RTOL} of max |value|{int8_text}: PASS")
    return dict(prefill=errs[0], decode=max(errs[1:]),
                worst_leaf=leaf_errs[worst_leaf], int8_apart=apart,
                int8_values=n_quant)


def _to_device(tree: dict, dev) -> dict:
    return {k: _to_device(v, dev) if isinstance(v, dict) else
            v.detach().to(dev) for k, v in tree.items()}


@contextlib.contextmanager
def profile_ranges(arch: str):
    """Wrap the functions named by PROFILE_RANGES[arch] (module, function
    of repro_torch.models) in profiler ranges of their names, for
    `serve_profile`'s `ranges`."""
    import importlib
    from unittest import mock
    import torch
    with contextlib.ExitStack() as stack:
        for mod_name, name in PROFILE_RANGES.get(arch, {}).values():
            mod = importlib.import_module(f"repro_torch.models.{mod_name}")
            fn = getattr(mod, name)

            def ranged(*a, _fn=fn, _name=name, **kw):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **kw)
            stack.enter_context(mock.patch.object(mod, name, ranged))
        yield


def serve_phase(dev, seed: int, card: str, arch: str) -> dict:
    """`arch` at full width (a MoE arch at every published width, its depth
    cut to SERVE_PERIODS) through the port's serve driver, then the same
    weights with the kernel's `ops` function replaced by its plain version:
    the kernel's prefill and teacher-forced decode logits against the plain
    run's, and a float32 prefill of batch 1 held tighter.  A hybrid or MoE
    arch also runs its reduced config on the card against the CPU."""
    from unittest import mock
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import host_time, serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_params

    kname, op, plain, second, (ph, ph32) = SERVED[arch]
    if isinstance(plain, str):
        plain = getattr(ref, plain)
    cfg = serve.serve_config(arch, periods=SERVE_PERIODS.get(arch))
    torch.cuda.reset_peak_memory_stats(dev)
    start_bytes = torch.cuda.memory_allocated(dev)
    b, p, g = SERVE_BATCH, SERVE_PROMPT, SERVE_GENS[arch]
    t0 = time.perf_counter()
    model = init_params(cfg, seed=seed, device=dev)
    woken = wake_inert_leaves(model, seed)
    sync(dev)
    n_params = model.num_params()
    cut = (f", the first {SERVE_PERIODS[arch]} of "
           f"{serve.serve_config(arch).num_periods} periods"
           if arch in SERVE_PERIODS else "")
    log(f"phase {ph} {arch}: {n_params / 1e6:.1f}M parameters "
        f"({cfg.num_layers} layers{cut}, d_model {cfg.d_model}, "
        f"{cfg.dtype}) initialized on the card in "
        f"{time.perf_counter() - t0:.2f} s"
        + (f"; {len(woken)} inert leaves drawn from the seed "
           f"({', '.join(sorted({w.rsplit('.', 1)[-1] for w in woken}))})"
           if woken else ""))
    prompts = torch.as_tensor(serve.make_prompts(cfg, b, p, seed),
                              device=dev)
    vis = vision_input(cfg, b, seed, dev)
    serve.generate(model, prompts[:, :128], 2, vision_embeds=vis)  # warm up

    ops.reset_launch_counts()
    run = serve.generate(model, prompts, g, vision_embeds=vis)
    counts = ops.launch_counts()
    n_pre, n_dec = pass_launches(cfg), pass_launches(cfg, decode=True)
    passes = f"{n_pre} + {n_dec} x {g - 1}"
    want = n_pre + n_dec * (g - 1)
    if counts[kname] != want or \
            any(n for k, n in counts.items() if k != kname):
        fail(f"serve {arch}: launches {counts}, want {kname} = {passes} = "
             f"{want}")
    kmod = ops.KERNELS[kname]
    got_routes = kmod.route_counts()
    on_prefill, on_decode = SERVE_ROUTES[arch]
    want_r = dict.fromkeys(got_routes, 0)
    want_r[on_prefill] += n_pre
    want_r[on_decode] += n_dec * (g - 1)
    on_decode_text = (on_decode if n_dec else "none: the absorbed MLA "
                      "decode is plain PyTorch")
    if got_routes != want_r:
        fail(f"serve {arch}: {kname} routes {got_routes}, want {want_r} "
             f"(every prefill call on {on_prefill}, decode "
             f"{on_decode_text})")
    routes = (f" (routes {got_routes}: prefill on {on_prefill}, decode "
              f"{on_decode_text})")
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
        f"{kname} launches {counts[kname]} = {passes}{routes}; peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; card {card}")
    if arch == "gemma2-2b":
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
        lg, cache = prefill(model, prompts, vis)
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
        lg, cache = prefill(model, prompts, vis)
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
    ranges = PROFILE_RANGES.get(arch)
    with profile_ranges(arch):
        prof = serve_profile(lambda: (prefill(model, prompts, vis),
                                      sync(dev)),
                             f"prefill (B {b}, S {p})", PROFILE_PARTS[arch],
                             ph, ranges)
        prof_dec = serve_profile(
            lambda: ([decode(model, cache, plain_toks[i], p + i)
                      for i in range(g - 4, g - 1)], sync(dev)),
            "3 decode steps", PROFILE_PARTS[arch], ph, ranges)
    del cache
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"phase {ph} {arch}: peak device memory {peak / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated over the bf16 runs, the plain "
        f"ones among them; {start_bytes / 1e9:.2f} GB held before the "
        f"phase); card {card}")

    tree = model.tree()
    del model
    torch.cuda.empty_cache()
    model32, cfg32, keep, f32_bytes = float32_model(tree, cfg)
    del tree
    layers32 = cfg32.num_layers
    which = (f"all {layers32} layers" if layers32 == cfg.num_layers else
             f"the first {layers32} of {cfg.num_layers} layers: the float32 "
             f"weights of all would be {f32_bytes / 1e9:.1f} GB, over "
             f"{F32_WEIGHTS_BYTES / 1e9:.0f}")
    n32 = pass_launches(cfg32)
    vis32 = None if vis is None else vis[:1].float()
    if n32 == 0:
        fail(f"serve {arch} float32: no attention layer fits "
             f"{F32_WEIGHTS_BYTES / 1e9:.0f} GB in float32")
    prefill32 = make_prefill_step(cfg32, s_max=p)
    ops.reset_launch_counts()
    lk, _ = prefill32(model32, prompts[:1], vis32)
    if ops.launch_counts()[kname] != n32:
        fail(f"serve {arch} float32: the prefill launched the kernel "
             f"{ops.launch_counts()[kname]} times, want {n32}")
    f32_route = SERVE_F32_ROUTE[arch]
    if kmod.route_counts()[f32_route] != n32:
        fail(f"serve {arch} float32: routes {kmod.route_counts()}, want "
             f"{f32_route} {n32} (float32 prefill stays on the "
             "CUDA cores)")
    with mock.patch.object(ops, op, plain):
        lp, _ = prefill32(model32, prompts[:1], vis32)
    e32 = rel_err(lk, lp)
    if not e32 <= SERVE_F32_RTOL or not bool(torch.isfinite(lk).all()):
        fail(f"serve {arch} float32: kernel against plain prefill logits "
             f"{e32:.3g} > {SERVE_F32_RTOL} of max|logits|")
    log(f"phase {ph32} serve {arch} float32 prefill (B 1, S {p}, TF32 off, "
        f"{which}, {n32} {f32_route} launches; the bf16 model dropped and "
        f"its weights cast leaf by leaf): kernel against plain within "
        f"{e32:.3g} of max|logits| <= {SERVE_F32_RTOL}: PASS")
    del model32
    torch.cuda.empty_cache()
    out = dict(counts=counts, routes=got_routes, prefill_tps=prefill_tps,
               decode_tps=decode_tps, errs=errs, e32=e32, tol=tol,
               f32_layers=layers32, f32_launches=n32,
               prefill_s=run["prefill_s"], decode_s=run["decode_s"])
    if arch in HYBRID_ARCHS + MOE_ARCHS:
        out["prefill_profile"] = {k: v for k, v in prof.items()
                                  if k != "top"}
        out["card_vs_cpu"] = card_cpu_phase(arch, seed, dev, ph)
    if arch in MOE_ARCHS:
        out.update(decode_profile={k: v for k, v in prof_dec.items()
                                   if k != "top"},
                   peak_bytes=peak, layers=cfg.num_layers,
                   params_m=n_params / 1e6)
    return out


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

def slo_decisions(label: str, server) -> list:
    """The server's SLO decisions, (p95 ms, level before -> after, chunk
    budget) each; fails when no window closed."""
    slo = server.stats()["slo"]
    if not slo["decisions"]:
        fail(f"{label}: no SLO window closed ({slo['samples']} predict "
             f"latencies, window {slo['window']})")
    return [(round(d["p95_ms"], 3), f"{d['level_before']}->{d['level']}",
             d["chunk_events"]) for d in slo["decisions"]]


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
    store0, rows = make_store(seed)
    base = store0.state()
    traffic = serve_traffic(rows, seed)
    problem = store0.problem(dev)
    cfg = configs()[0]
    v0 = (np.float32(0.01) * np.random.default_rng(seed + 5).standard_normal(
        (D, T), dtype=np.float32))
    key = prng.key_from_seed(seed)
    sc = ServeConfig(**dict(SERVE_CFG, slo_window=SERVE_SLO_WINDOW),
                     ckpt_dir=str(ckpt_dir))
    expected = TaskStore(*base, "lstsq", "nuclear", LAM)
    for _, _, ft, fx, fy in traffic:
        expected.append(ft, fx, fy)
    sync(dev)
    ops.reset_launch_counts()
    card_events = 0

    # 1. cooperative serving, the checkpoint at SERVE_RESUME_AT batches, a
    # resume
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
    if [c[2] for c in ckpts] != [at] or a.event_count != total:
        fail(f"serve: checkpoints at {[c[2] for c in ckpts]}, "
             f"{a.event_count} events; want [{at}] and {total}")
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
    slo_a, slo_b = slo_decisions("serve", a), slo_decisions("resumed", b)
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
    slo_c = slo_decisions("threaded serving", c)
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
                                   checkpoint_every=None,
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
        "slo_decisions": {"serve": slo_a, "resumed": slo_b,
                          "threaded": slo_c},
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
    log(f"phase 20 SLO decisions (window {SERVE_SLO_WINDOW}; p95 ms, level, "
        f"chunk budget): cooperative {slo_a}, resumed {slo_b}, threaded "
        f"{slo_c}")
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
                  batch: dict, worlds: list) -> dict:
    """Phase 21: the task-sharded engine at the batch cell's width, one
    rank in this process (21a) and SHARD_RANKS ranks on this card
    (21b-21f, in `worlds`: the save in the first, its restore in the
    second), against the batch engine's states."""
    import torch
    from repro_torch.core import amtl
    from repro_torch.kernels import ops
    from repro_torch.launch import amtl_sharded

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
    out = worlds[0].run(amtl_sharded.session,
                        dict(device=dev.type, problems=problems, runs=runs),
                        timeout=SHARD_WORLD_TIMEOUT_S)
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

    # 21e: save at the midpoint, restore in the other world (ranks that
    # never ran the session that saved), run on
    if not all(np.array_equal(a, b) for a, b in
               zip(r0[4]["leaves"], r0[0]["leaves"])):
        fail("21e checkpoint: the run that saved differs from 21b's")
    t1 = time.perf_counter()
    again = worlds[1].run(amtl_sharded.session, dict(
        device=dev.type, problems=problems,
        runs=[dict(base, cfg=fields(repl),
                   restore=(str(ckpt), BATCH_EVENTS // 2))]),
        timeout=SHARD_WORLD_TIMEOUT_S)
    world_s += time.perf_counter() - t1
    shutil.rmtree(ckpt, ignore_errors=True)
    if not all(np.array_equal(a, b) for a, b in
               zip(again[0][0]["leaves"], r0[0]["leaves"])):
        fail("21e checkpoint: the restored world's run is not bitwise the "
             "uninterrupted run")
    log(f"phase 21e checkpoint: saved at event {BATCH_EVENTS // 2} by "
        f"{SHARD_RANKS} ranks, restored in another world and run to "
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
    log(f"phase 21 worlds: {world_s:.1f} s of calls with set-up (the "
        "ranks up since phase 20)")
    kernels = shard_kernel_times(dev, seed) if dev.type == "cuda" else {}
    log("sharded " + json.dumps({"card": card, "times": times,
                                 "kernels": kernels}))
    return {"launches": sharded_launches,
            "rank_launches": r0[0]["launches"], "kernels": kernels}


# ----------------------------------------------------------- phases 24-25 --

# Training at a published width: gemma2-2b (phase 24; configs/gemma2_2b.py:
# 26 layers, d_model 2304, 8 heads, GQA kv 4, head_dim 256, d_ff 9216,
# vocab 256000, window 4096, softcaps 50 and 30, GeGLU, tied embeddings,
# bf16) and rwkv6-3b (phase 25; configs/rwkv6_3b.py: 32 layers, d_model
# 2560, 40 heads of 64, d_ff 8960, vocab 65536, bf16, 3073.5M parameters):
# random weights from --seed, batch 2 x seq 2048 from synthetic_lm_batches,
# remat on, TRAIN_STEPS steps of AdamW (an fp32 master, mu and nu) with the
# head's AMTL round (T 16, tau 4, nuclear) inside each.  hubert-xlarge
# (phase 32; configs/hubert_xlarge.py: 48 attn layers, d_model 1280, 16
# heads, kv 16, hd 80, d_ff 5120, GeLU, LayerNorm, non-causal, 504 cluster
# targets, frame features of 1280, 946.9M parameters) trains the same way
# at ENCODER_BATCH x ENCODER_SEQ frames: 250k samples of 16 kHz audio
# through the 320-sample stride of its (stubbed) frontend, wav2vec 2.0's
# pretraining crop; 781 is a multiple of neither 64 nor 128, so the kernels'
# row and key tails run at full width.  The batches are `batches_for`'s:
# frame features, 30 % of the frames masked, the loss over those.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
ENCODER_BATCH, ENCODER_SEQ = 8, 781
# Step 0's loss and every parameter leaf's gradient through the kernels
# against the same step with the arch's kernel op replaced by its plain
# version under autograd on the card, by ||diff|| / ||plain grad|| a leaf:
# bf16 rounding differences carried through the layers and back.  On an
# H100 the sound gemma2-2b readings were a loss 1.3e-5 apart and leaves
# 0.0149 (median) to 0.0197 (worst, the FFN gates); its control, the plain
# run with the local layers' window cut to 1024, read 0.078 (median) to
# 0.103.  Limits 1e-3 and 0.05, for both archs.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_RTOL = 0.05
# The head's ring after the run against a CPU replay of its rounds from the
# card's pooled states: float32 sums in another order.
HEAD_RTOL = 1e-5
# gemma2-2b's control: the local layers' window in the plain run.
TRAIN_CONTROL_WINDOW = 1024
# The device-time parts of a train step, by kernel name.
TRAIN_PARTS = {"flash_attention_bwd": ("fa_bwd_",),
               "bwd lse": ("fa_bwd_sm90_lse",), "bwd dq": ("fa_bwd_sm90_dq",),
               "bwd dkdv": ("fa_bwd_sm90_dkdv",),
               "flash sm90": ("flash_sm90_kernel",),
               "matmul": ("gemm", "sm90_xmma", "cutlass", "nvjet")}
# zamba2-7b's and llama-3.2-vision-11b's also PyTorch's elementwise
# kernels (the SSD's, the norms', the optimizer's), and for zamba2 (by the
# profiler ranges of PROFILE_RANGES) the mamba mixers and their SSD, each
# range over its forward and its recompute under remat (the backward runs
# outside the range: `ssd_times` times it alone).
HYBRID_TRAIN_PARTS = {**TRAIN_PARTS, "elementwise": ("elementwise",)}
# zamba2-7b and llama-3.2-vision-11b (phases 33-34) train at their
# published widths with their depth cut to TRAIN_PERIODS periods
# (`train_depth_cut`), the most that keep the peak under ~70 GB: bf16
# weights and gradients and AdamW's float32 master and moments, 16 bytes
# a parameter, are 92.0 and 161.8 GB at the published 13 and 8 periods.
# On an H100 zamba2 at 6 periods (48.2 GB of them, 39 layers, 3 of them
# the tail's mamba) peaked at 58.73 GB driven alone; at 7 (54.5 GB) at
# 72.52 GB in the whole smoke, ~7.5 GB of it held by earlier phases: so
# 6.  llama at 2 periods (53.1 GB; 10 layers, 2 cross) peaked at 57.61
# alone and 65.15 in the smoke; 3 would be 71.2 GB before the
# activations.  zamba2 keeps 2 periods or more so the tied block's
# gradient sums over its invocations, llama a cross layer.
TRAIN_PERIODS = {"zamba2-7b": 6, "llama-3.2-vision-11b": 2,
                 "dbrx-132b": 1, "deepseek-v3-671b": 0}
# dbrx-132b and deepseek-v3-671b (phases 37-38) train under Adafactor, not
# their default AdamW: AdamW's bf16 weight and gradient and float32
# master, mu and nu are 16 bytes a parameter, 72 GB for one dbrx layer
# (3.26G parameters) and the embeddings before any activation.
# Adafactor's (its factored moments are small) are 8 bytes, and its update
# makes ~4 float32 copies of a leaf at a time: 4.2 GB each for one dbrx
# layer's stacked w_in.  So dbrx runs 1 of its 40 moe layers (4.49G
# parameters, 36 GB of state); 2 would be 62 GB of state and 34 GB of
# update copies.  deepseek runs its 3 dense MLA layers and the MTP block
# (0 of its 58 moe layers: one is 11.5G parameters, 92 GB of state alone;
# 4.29G parameters, 34 GB).
TRAIN_OPTIMIZER = "adafactor"
# The state bytes a parameter under each optimizer (bf16 weight and
# gradient, the float32 master, and AdamW's float32 mu and nu), and the
# float32 copies of one leaf that Adafactor's update holds at a time.
STATE_BYTES = {"adamw": 16, "adafactor": 8}
ADAFACTOR_COPIES = 4


def train_sizing(published, periods: int, optimizer: str,
                 card_bytes: int) -> str:
    """Why a phase trains `published` at `periods` periods under
    `optimizer`: the state of that cut under it and under the arch's
    default optimizer, and the state of one period more (with the
    update's float32 copies of its largest leaf) against the card."""
    from repro_torch.launch.steps import default_optimizer
    from repro_torch.models import transformer

    def size(p):
        shapes = transformer.param_shapes(train_depth_cut(published, p))
        return (sum(math.prod(x) for x in shapes.values()),
                max(math.prod(x) for x in shapes.values()))
    (n, _), (n1, big1) = size(periods), size(periods + 1)
    per = STATE_BYTES[optimizer]
    default = default_optimizer(published).name
    out = (f"{optimizer}: {per} B a parameter of state, {per * n / 1e9:.1f}"
           f" GB at this cut ({n / 1e9:.2f}G parameters)")
    if default != optimizer:
        out += (f"; the arch's default {default} holds "
                f"{STATE_BYTES[default]} B, {STATE_BYTES[default] * n / 1e9:.1f}"
                f" GB")
    more = per * n1 + ADAFACTOR_COPIES * 4 * big1
    return out + (
        f"; {periods + 1} period{'s' if periods else ''} (one more "
        f"{'+'.join(published.period)} layer, {(n1 - n) / 1e9:.2f}G "
        f"parameters, {per * (n1 - n) / 1e9:.1f} GB of state alone) would "
        f"hold "
        f"{per * n1 / 1e9:.1f} GB of state and {ADAFACTOR_COPIES} float32 "
        f"copies of its largest leaf ({big1 / 1e9:.2f}G elements) in the "
        f"update, {more / 1e9:.1f} GB, over the card's "
        f"{card_bytes / 1e9:.1f} GB")
# llama-3.2-vision-11b's control: the cross-attention's keys cut to the
# first CROSS_CONTROL_KEYS of the 1601 in the plain run (or, holding the
# backward alone, in the plain backward).
CROSS_CONTROL_KEYS = 1024
# dbrx-132b's and deepseek-v3-671b's also, by profiler range, the MoE
# FFN (its forward and its recompute under remat: `moe.moe_apply`).
MOE_TRAIN_RANGES = {"MoE": ("moe", "moe_apply")}
RWKV_TRAIN_PARTS = {"rwkv6_bwd": ("rwkv6_bwd_",),
                    "bwd states": ("rwkv6_bwd_states_kernel",),
                    "bwd chunk": ("rwkv6_bwd_chunk_kernel",),
                    "bwd du": ("rwkv6_bwd_chunked_du_kernel",),
                    "bwd recurrent": ("rwkv6_bwd_kernel",
                                      "rwkv6_bwd_du_kernel"),
                    "wkv chunked": ("rwkv6_chunked_kernel",),
                    "matmul": ("gemm", "sm90_xmma", "cutlass", "nvjet")}


def wkv_plain_grad(r, k, v, w, u, state, *, chunk: int):
    """`ops.wkv`'s training call through its plain version under autograd
    (`ref.wkv_chunked_ref`, differentiated by PyTorch): phase 25's
    yardstick."""
    from repro_torch.kernels import ref
    if state is not None:
        fail("phase 25: the training call handed ops.wkv a state")
    return ref.wkv_chunked_ref(r, k, v, w, u, chunk)[0].to(r.dtype)


def wkv_kernels_forward(backward):
    """`ops.wkv`'s training call with the kernels' forward and `backward`
    (r, k, v, w, u, do, chunk -> dr, dk, dv, dw, du) as its gradient: the
    runs that hold the backward kernel alone, on the same forward
    activations bit for bit."""
    import torch
    from repro_torch.kernels import ops

    class KernelForward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, w, u, chunk):
            ctx.save_for_backward(r, k, v, w, u)
            ctx.chunk = chunk
            return ops._wkv_forward(r, k, v, w, u, None, chunk)

        @staticmethod
        def backward(ctx, do):
            r, k, v, w, u = ctx.saved_tensors
            return (*backward(r, k, v, w, u, do.to(r.dtype), ctx.chunk),
                    None)

    def call(r, k, v, w, u, state, *, chunk: int):
        if state is not None:
            fail("phase 25: the training call handed ops.wkv a state")
        return KernelForward.apply(r, k, v, w, u, chunk)
    return call


def wkv_bwd_ref_cut(r, k, v, w, u, do, chunk: int):
    """The plain backward (`ref.wkv_bwd_ref`) of two independent halves,
    cut at the chunk boundary nearest the middle: the state's gradient
    dropped there, as phase 3's control drops it.  Every leaf's plain
    gradient stays non-zero."""
    import torch
    from repro_torch.kernels import ref
    ell = r.shape[1]
    cut = max(chunk, ell // 2 // chunk * chunk)
    a = ref.wkv_bwd_ref(*(t[:, :cut] for t in (r, k, v, w)), u, do[:, :cut],
                        chunk)
    b = ref.wkv_bwd_ref(*(t[:, cut:] for t in (r, k, v, w)), u, do[:, cut:],
                        chunk)
    return (*(torch.cat([x, y], 1) for x, y in zip(a[:4], b[:4])),
            a[4] + b[4])


def wkv_ref_backward(r, k, v, w, u, do, chunk: int):
    from repro_torch.kernels import ref
    return ref.wkv_bwd_ref(r, k, v, w, u, do, chunk)


# hubert-xlarge's control: the plain attention with every key more than
# HUBERT_CONTROL_WINDOW frames left of its query dropped.  (A causal mask
# does not serve: a masked first frame, zero with the zero mask_emb, then
# sees only itself and stays zero through every layer, and each
# LayerNorm's backward over that zero-variance row multiplies the gradient
# by 1/sqrt(eps): the gradients overflow on the kernels' path and the
# plain ones alike, on an H100 at full width.)
HUBERT_CONTROL_WINDOW = 64


def mha_ref_windowed(q, k, v, *, window=None, **kw):
    """`ref.mha_ref` with the window at HUBERT_CONTROL_WINDOW: phase 32's
    control."""
    from repro_torch.kernels import ref
    return ref.mha_ref(q, k, v, window=HUBERT_CONTROL_WINDOW, **kw)


# The run that holds rwkv6-3b's backward kernel (the kernels' forward, the
# plain backward) and its control (the same with the state's gradient
# dropped at the middle).
wkv_plain_backward = wkv_kernels_forward(wkv_ref_backward)
wkv_plain_backward_cut = wkv_kernels_forward(wkv_bwd_ref_cut)


def mha_kernels_forward(backward):
    """`ops.mha`'s training call with the kernels' forward and `backward`
    (q, k, v, o, do, mask -> dq, dk, dv) as its gradient: the runs that
    hold the attention's backward kernel alone, on the same forward
    activations bit for bit."""
    import torch
    from repro_torch.kernels import ops

    class KernelForward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask, kv_chunk):
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            o = ops._mha_forward(q, k, v, mask, kv_chunk)
            ctx.save_for_backward(q, k, v, o)
            ctx.mask = mask
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o = ctx.saved_tensors
            return (*backward(q, k, v, o, do.contiguous(), ctx.mask), None,
                    None)

    def call(q, k, v, *, causal: bool, window=None, softcap=None,
             q_offset: int = 0, kv_valid_len=None, kv_chunk: int = 1024):
        return KernelForward.apply(q, k, v, dict(
            causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, kv_valid_len=kv_valid_len), kv_chunk)
    return call


def control_mask(mask: dict, window=None, cross_keys=None) -> dict:
    """An attention call's mask with the causal calls' window at `window`
    or the non-causal calls' keys cut to the first `cross_keys`: the
    hybrid archs' training controls."""
    mask = dict(mask)
    if window is not None and mask["causal"]:
        mask["window"] = window
    if cross_keys is not None and not mask["causal"]:
        mask["kv_valid_len"] = cross_keys
    return mask


def mha_ref_control(window=None, cross_keys=None):
    """`ref.mha_ref` at `control_mask`'s mask: a plain run's control."""
    def call(q, k, v, *, kv_chunk: int = 1024, **mask):
        from repro_torch.kernels import ref
        return ref.mha_ref(q, k, v, kv_chunk=kv_chunk, **control_mask(
            mask, window, cross_keys))
    return call


def mha_bwd_plain(window=None, cross_keys=None):
    """The sm90 backward's plain version (`ref.mha_bwd_ref`, P and dS
    rounded to bf16) as a `mha_kernels_forward` backward; a control's with
    the causal calls' window at `window` or the non-causal calls' keys cut
    to the first `cross_keys`."""
    def backward(q, k, v, o, do, mask):
        return bwd_plain("sm90", q, k, v, o, do, control_mask(
            mask, window, cross_keys))
    return backward


def mha_ref_bf16_p(q, k, v, **mask):
    """`ref.mha_ref` with P rounded to bf16 in 64-key chunks, the sm90
    forward's order and rounding in plain PyTorch (phase 3's yardstick of
    that route): dbrx-132b's second plain version in training.  The
    caller's `kv_chunk` (the float32-P plain version's order) is replaced
    by the sm90 forward's 64-key tiles."""
    import torch
    from repro_torch.kernels import ref
    mask.pop("kv_chunk")
    return ref.mha_ref(q, k, v, kv_chunk=64, p_dtype=torch.bfloat16,
                       **mask)


# Each trained arch: its phase, the kernel module of its forward and of
# its backward, the `ops` function that reaches them, that function's
# plain version under autograd, the run that holds the backward alone
# (the kernels' forward with the plain backward; None: none), a second
# plain version (`noise`, optional), the controls (a function and a
# config change; the run must fail the gate) of the plain gate
# (`control`) and of the held one (`held_control`), the `ref` functions
# that must not run on the kernels' path, the routes that must take every
# forward launch and every backward one (the module's other routes none),
# the leaves whose gradient must be non-zero (a name or a dotted suffix of
# the path), and the profile's parts (and profiler ranges); `wake` draws
# the inert leaves.  Step 0 is
# gated on the whole plain run, unless the spec holds the backward alone
# and has no second plain version, or the two plain versions differ by
# more than TRAIN_GRAD_RTOL: then on the held run.
#
# dbrx-132b's router amplifies the forward's rounding: a token whose k-th
# and (k+1)-th experts are near a tie goes to another expert when the
# attention's output moves by a bf16 ulp.  On an H100 (one layer, B 2 x
# 2048) the kernels read 0.0519 from the float32-P plain run at the router
# (median leaf 0.0413), while a second float32-P plain attention read
# 0.0136 and the kernels' forward with the plain backward 0.0022 (the
# same routing).  The sm90 forward rounds P to bf16, as its plain version
# in phase 3 does, and that plain version (`mha_ref_bf16_p`, dbrx's second
# plain run) read 0.059 from the float32-P run: past TRAIN_GRAD_RTOL, so
# the rule above gates dbrx on the backward alone.
#
# rwkv6-3b's random-weight bf16 model amplifies any difference in its
# WKV's float32 sums through 32 layers: on an H100 two plain versions
# (chunk 128 and 64) read 0.096 apart (worst leaf), the kernels against
# the plain version 0.142 (median 0.11).  So the whole plain run is only a
# logged reading there (with the loss gate and the non-zero leaves), and
# the gate holds the backward kernel alone: the kernels' forward with the
# plain backward, the same activations bit for bit (read 0.0215, median
# 0.0193), at TRAIN_GRAD_RTOL.
TRAINED = {
    "gemma2-2b": dict(
        phase=24, fwd="flash_attention", bwd="flash_attention_bwd", op="mha",
        plain="mha_ref", held=None, control=("mha_ref", dict(
            sliding_window=TRAIN_CONTROL_WINDOW)),
        control_label=f"plain run, local window {TRAIN_CONTROL_WINDOW}",
        plain_calls=("mha_ref", "mha_bwd_ref"),
        fwd_routes={"sm90"},
        bwd_routes={"sm90"}, nonzero=(), parts=TRAIN_PARTS),
    "rwkv6-3b": dict(
        phase=25, fwd="rwkv6_scan", bwd="rwkv6_bwd", op="wkv",
        plain=wkv_plain_grad, held=wkv_plain_backward,
        held_control=(wkv_plain_backward_cut, {}),
        held_control_label="the kernels' forward, the plain backward with "
                           "the state's gradient dropped at the middle",
        plain_calls=("wkv_chunked_ref", "wkv_inplace_ref", "wkv_bwd_ref",
                     "wkv_bwd_exact_ref"),
        fwd_routes={"chunked"},
        bwd_routes={"chunked"},
        nonzero=("wr", "wk", "wv", "w0", "w_lora_a", "w_lora_b", "u"),
        parts=RWKV_TRAIN_PARTS),
    "hubert-xlarge": dict(
        phase=32, fwd="flash_attention", bwd="flash_attention_bwd", op="mha",
        plain="mha_ref", held=None, control=(mha_ref_windowed, {}),
        control_label="plain run, keys more than "
                      f"{HUBERT_CONTROL_WINDOW} frames back dropped",
        plain_calls=("mha_ref", "mha_bwd_ref"),
        fwd_routes={"sm90"},
        bwd_routes={"sm90"}, nonzero=("feat_proj", "mask_emb"),
        parts=TRAIN_PARTS, shape=(ENCODER_BATCH, ENCODER_SEQ),
        unit="frames"),
    "zamba2-7b": dict(
        phase=33, fwd="flash_attention", bwd="flash_attention_bwd", op="mha",
        plain="mha_ref", held=mha_kernels_forward(mha_bwd_plain()),
        noise=mha_dense_plain,
        control=(mha_ref_control(window=TRAIN_CONTROL_WINDOW), {}),
        control_label="plain run, the shared attention's window at "
                      f"{TRAIN_CONTROL_WINDOW}",
        held_control=(mha_kernels_forward(mha_bwd_plain(
            window=TRAIN_CONTROL_WINDOW)), {}),
        held_control_label="the kernels' forward, the plain backward with "
                           "the shared attention's window at "
                           f"{TRAIN_CONTROL_WINDOW}",
        plain_calls=("mha_ref", "mha_bwd_ref"),
        fwd_routes={"sm90"},
        bwd_routes={"sm90"},
        nonzero=("lora_q_a", "lora_q_b", "lora_o_a", "lora_o_b", "A_log",
                 "D", "dt_bias", "shared_attn.attn.wq",
                 "shared_attn.attn.wk", "shared_attn.attn.wv",
                 "shared_attn.attn.wo"),
        parts=HYBRID_TRAIN_PARTS, ranges=PROFILE_RANGES["zamba2-7b"],
        wake=True),
    "llama-3.2-vision-11b": dict(
        phase=34, fwd="flash_attention", bwd="flash_attention_bwd", op="mha",
        plain="mha_ref", held=mha_kernels_forward(mha_bwd_plain()),
        noise=mha_dense_plain,
        control=(mha_ref_control(cross_keys=CROSS_CONTROL_KEYS), {}),
        control_label="plain run, the cross-attention's keys cut to the "
                      f"first {CROSS_CONTROL_KEYS}",
        held_control=(mha_kernels_forward(mha_bwd_plain(
            cross_keys=CROSS_CONTROL_KEYS)), {}),
        held_control_label="the kernels' forward, the plain backward with "
                           "the cross-attention's keys cut to the first "
                           f"{CROSS_CONTROL_KEYS}",
        plain_calls=("mha_ref", "mha_bwd_ref"),
        fwd_routes={"sm90"},
        bwd_routes={"sm90"},
        nonzero=("xattn.wq", "xattn.wk", "xattn.wv", "xattn.wo",
                 "xattn.gate"),
        parts=HYBRID_TRAIN_PARTS, wake=True),
    **{arch: {**dict(
        phase=ph, fwd="flash_attention", bwd="flash_attention_bwd",
        op="mha", plain=plain, held=mha_kernels_forward(mha_bwd_plain()),
        noise=mha_dense_plain,
        control=(mha_ref_control(window=TRAIN_CONTROL_WINDOW), {}),
        control_label=f"plain run, every layer's window at "
                      f"{TRAIN_CONTROL_WINDOW}",
        held_control=(mha_kernels_forward(mha_bwd_plain(
            window=TRAIN_CONTROL_WINDOW)), {}),
        held_control_label="the kernels' forward, the plain backward with "
                           f"every layer's window at {TRAIN_CONTROL_WINDOW}",
        plain_calls=("mha_ref", "mha_bwd_ref"),
        fwd_routes={"sm90"},
        bwd_routes={"sm90"}, nonzero=nonzero,
        parts=HYBRID_TRAIN_PARTS, ranges=MOE_TRAIN_RANGES,
        optimizer=TRAIN_OPTIMIZER, card_cpu=True), **extra}
       for arch, ph, plain, nonzero, extra in (
           ("dbrx-132b", 37, "mha_ref",
            ("moe.router", "moe.w_in", "moe.w_gate", "moe.w_out", "attn.wq",
             "attn.wk", "attn.wv", "attn.wo"),
            dict(noise=mha_ref_bf16_p,
                 noise_label="the plain attention with P rounded to bf16 "
                             "in 64-key chunks (the sm90 forward's "
                             "rounding)")),
           ("deepseek-v3-671b", 38, mha_ref_lean,
            ("attn.wq_a", "attn.wq_b", "attn.wkv_a", "attn.wk_b",
             "attn.wv_b", "attn.wo", "mtp."), {}))}}


def ssd_times(cfg, dev, seed: int) -> dict:
    """One mamba mixer's chunked SSD (`ssm._ssd_chunked`, plain PyTorch) at
    the training shape (B TRAIN_BATCH, L TRAIN_SEQ, the config's heads,
    head dim, state and chunk; x, B and C in the model's dtype, dt
    float32), alone with CUDA events: its forward, and its forward and
    backward under autograd (every input's gradient).  A train step runs
    the forward twice (once more under remat) and the backward once a
    mixer."""
    import torch
    from repro_torch.models import ssm
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.head_dim
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    mdt = getattr(torch, cfg.dtype)
    b, ell = TRAIN_BATCH, TRAIN_SEQ

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    x = randn(b, ell, h, s.head_dim).to(mdt)
    bm, cm = (randn(b, ell, s.n_groups, s.state_dim).to(mdt)
              for _ in range(2))
    dt = torch.nn.functional.softplus(randn(b, ell, h) - 1.0)
    a_log = torch.rand(h, generator=g, device=dev) * 2 - 1
    d = torch.rand(h, generator=g, device=dev) + 0.5
    dy = randn(b, ell, h, s.head_dim).to(mdt)
    inputs = [x, dt, a_log, bm, cm, d]
    leaves = [t.detach().requires_grad_() for t in inputs]

    def fwd():
        with torch.no_grad():
            return ssm._ssd_chunked(*inputs, s.chunk)

    def fwd_bwd():
        y, _ = ssm._ssd_chunked(*leaves, s.chunk)
        return torch.autograd.grad(y, leaves, dy)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fb = cuda_ms(fwd_bwd, reps=5, inner=3, warmup=1)
    peak = torch.cuda.max_memory_allocated(dev) - base
    f = cuda_ms(fwd, reps=5, inner=3, warmup=1)
    mixers = sum(k == "mamba" for k in cfg.layer_kinds)
    return dict(shape=[b, ell, h, s.head_dim, s.state_dim, s.chunk],
                fwd_ms=f, fwd_bwd_ms=fb, mixers=mixers,
                step_ms=mixers * (f + fb), fwd_bwd_peak_bytes=peak)


def train_grads(model, batch, cfg, p) -> tuple:
    """The train step's loss (LM loss plus probe_weight times the probe
    loss at the head's read p) and the gradient of every parameter leaf,
    by path (zeros for a leaf the loss does not reach), without an
    update."""
    import torch
    from repro_torch.core.mtl_head import probe_loss
    from repro_torch.models.transformer import forward
    from repro_torch.optim.optimizers import tree_items
    params = model.tree()
    for leaf in model.parameters():
        leaf.grad = None
    with torch.enable_grad():
        loss, metrics = forward(params, batch, cfg, remat=True)
        total = loss + cfg.mtl.probe_weight * probe_loss(
            p, metrics["pooled"], batch["task_ids"],
            batch["mtl_targets"].float())
        total.backward()
    grads = {".".join(path): leaf.grad if leaf.grad is not None
             else torch.zeros_like(leaf) for path, leaf in tree_items(params)}
    for leaf in model.parameters():
        leaf.grad = None
    return float(total.detach()), grads


def leaf_errs(got: dict, want: dict) -> dict:
    """Per leaf: (max |got - want| / max |want|, ||got - want|| / ||want||)
    in float32."""
    out = {}
    for k in want:
        g, w = got[k].float(), want[k].float()
        d = g - w
        out[k] = ((d.abs().max() / w.abs().max().clamp_min(1e-30)).item(),
                  (d.norm() / w.norm().clamp_min(1e-30)).item())
    return out


def train_phase(dev, seed: int, card: str, arch: str) -> dict:
    """Phases 24, 25 and 32-34: `repro_torch.launch.train`'s path
    (init_train_state, ShardedBatcher over batches_for, make_train_step) at
    `arch`'s full width (zamba2-7b and llama-3.2-vision-11b at
    TRAIN_PERIODS periods, their inert leaves drawn by
    `wake_inert_leaves`).  Fails unless step 0's loss and gradients through
    the kernels match the plain version's under autograd (or, where the
    spec holds the backward alone, the kernels' forward with the plain
    backward) and the control does not, each step's staleness and mask are
    the host replay's bits, the head's ring matches a CPU replay of its
    rounds, each step launches exactly `train_launches` forwards (each
    call of a pass twice under remat) and backwards on their routes, and
    no plain version, and every loss is finite."""
    from unittest import mock
    import torch
    from repro_torch.core import mtl_head, prng
    from repro_torch.data import ShardedBatcher
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import (default_optimizer,
                                          init_train_state, make_train_step,
                                          train_keys)
    from repro_torch.models import init_params
    from repro_torch.optim import cosine_warmup, make_optimizer

    spec = TRAINED[arch]
    ph, op = spec["phase"], spec["op"]
    fwd_mod, bwd_mod = ops.KERNELS[spec["fwd"]], ops.KERNELS[spec["bwd"]]
    plain = spec["plain"]
    plain = getattr(ref, plain) if isinstance(plain, str) else plain
    t_phase = time.perf_counter()
    free0, total_mem = torch.cuda.mem_get_info(dev)
    cfg = published = train_mod.train_config(arch, reduced=False)
    if arch in TRAIN_PERIODS:
        cfg = train_depth_cut(published, TRAIN_PERIODS[arch])
    mcfg = cfg.mtl
    n_layers = cfg.num_layers
    n_fwd, n_calls = train_launches(cfg)
    t_batch, t_seq = spec.get("shape", (TRAIN_BATCH, TRAIN_SEQ))
    unit = spec.get("unit", "tokens")
    torch.cuda.reset_peak_memory_stats(dev)
    held0 = torch.cuda.memory_allocated(dev)      # earlier phases' tensors
    if cfg is not published:
        log(f"phase {ph} {arch} training depth: published "
            f"{published.num_layers} layers ({len(published.head_blocks)} "
            f"head, {published.num_periods} periods of "
            f"{'+'.join(published.period)}, {len(published.tail_blocks)} "
            f"tail), cut to {n_layers} layers ({cfg.num_periods} periods)"
            + (", and the MTP block" if cfg.mtp else "")
            + ", every width published")
    if spec.get("optimizer"):
        log(f"phase {ph} {arch} optimizer and depth: "
            + train_sizing(published, cfg.num_periods, spec["optimizer"],
                           total_mem))
    model = init_params(cfg, seed=seed, device=dev)
    model.requires_grad_(True)
    drawn = wake_inert_leaves(model, seed) if spec.get("wake") else []
    sync(dev)
    log(f"phase {ph} {arch} training: {model.num_params() / 1e6:.1f}M "
        f"parameters ({n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}"
        f"), {free0 / 1e9:.1f} GB free of {total_mem / 1e9:.1f} GB before "
        "the phase"
        + (f"; the reference's inert leaves drawn by wake_inert_leaves: "
           + ", ".join(f"{n} x{c}" for n, c in sorted(collections.Counter(
               p.rsplit(".", 1)[-1] for p in drawn).items()))
           if drawn else ""))
    data = ShardedBatcher(train_mod.batches_for(cfg, t_seq, t_batch),
                          device=dev)
    batches = [next(data) for _ in range(TRAIN_STEPS)]
    want_step = {spec["fwd"]: n_fwd, spec["bwd"]: n_calls}
    # the spec's route takes every launch, the module's others none
    want_fwd = {r: n_fwd if r in spec["fwd_routes"] else 0
                for r in fwd_mod.route_counts()}
    want_bwd = {r: n_calls if r in spec["bwd_routes"] else 0
                for r in bwd_mod.route_counts()}
    bwd_routes = bwd_mod.route_counts

    # step 0 through the kernels against the plain version, no update
    p0 = torch.zeros((cfg.d_model, mcfg.num_tasks), dtype=torch.float32,
                     device=dev)       # the zero head's read at step 0
    ops.reset_launch_counts()
    loss_k, grads_k = train_grads(model, batches[0], cfg, p0)
    counts, routes0 = ops.launch_counts(), bwd_routes()
    grads_k = {k: g.clone() for k, g in grads_k.items()}
    with mock.patch.object(ops, op, plain):
        loss_p, grads_p = train_grads(model, batches[0], cfg, p0)
        errs = leaf_errs(grads_k, grads_p)
    noise = None
    if spec.get("noise") is not None:    # a second plain version
        with mock.patch.object(ops, op, spec["noise"]):
            _, grads_n = train_grads(model, batches[0], cfg, p0)
        noise = leaf_errs(grads_n, grads_p)
        del grads_n
    del grads_p
    # the gate: the whole plain run; or the backward alone (the kernels'
    # forward with the plain backward, on the same activations) where the
    # spec has no second plain version (rwkv6-3b) or two plain versions
    # already differ by more than the gate
    plain_noise = None if noise is None else max(
        e[1] for e in noise.values())
    use_held = spec["held"] is not None and (
        plain_noise is None or plain_noise > TRAIN_GRAD_RTOL)
    held = None
    if spec["held"] is not None:
        with mock.patch.object(ops, op, spec["held"]):
            _, grads_h = train_grads(model, batches[0], cfg, p0)
        held = leaf_errs(grads_k, grads_h)
        del grads_h
    gated = held if use_held else errs
    kind = "held_control" if use_held else "control"
    (control_fn, control_cfg), control_label = spec[kind], \
        spec[f"{kind}_label"]
    control_fn = getattr(ref, control_fn) if isinstance(control_fn, str) \
        else control_fn
    # the control's run must fail the gate
    with mock.patch.object(ops, op, control_fn):
        _, grads_c = train_grads(model, batches[0],
                                 dataclasses.replace(cfg, **control_cfg), p0)
        cerrs = leaf_errs(grads_k, grads_c)
        del grads_c
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    sound = max(e[1] for e in gated.values())
    control = max(e[1] for e in cerrs.values())
    zero = [k for k, g in grads_k.items()
            if named(k, spec["nonzero"]) and not float(g.norm()) > 0]
    zero += [n for n in spec["nonzero"]
             if not any(named(k, (n,)) for k in grads_k)]   # no such leaf

    def reading(e: dict) -> str:
        return (f"worst {sorted(e.items(), key=lambda kv: -kv[1][1])[:3]}, "
                f"median {statistics.median(x[1] for x in e.values()):.3g}")
    gate_run = "the kernels' forward with the plain backward" if use_held \
        else f"the plain {op}"
    log(f"phase {ph} step 0 through the kernels against the plain {op} "
        f"on the card: loss {loss_k:.6f} vs {loss_p:.6f} ({loss_err:.3g}); "
        "gradients (max |diff| / max |grad|, ||diff|| / ||grad||) a leaf: "
        + reading(errs) + (" (a reading, not gated)" if use_held else "")
        + ("" if noise is None else
           f"; {spec.get('noise_label', 'a second plain version')} against "
           f"the plain one (the bf16 noise between two plain runs, "
           f"{plain_noise:.3g}"
           + (" > " if use_held else " <= ") + f"{TRAIN_GRAD_RTOL}: the "
           f"gate holds {gate_run}): " + reading(noise))
        + ("" if held is None else
           "; against the kernels' forward with the plain backward"
           + ("" if use_held else " (a reading, not gated)") + ": "
           + reading(held))
        + f"; control ({control_label}) " + reading(cerrs)
        + f"; limits: loss {TRAIN_LOSS_RTOL}, ||diff|| / ||grad|| "
        f"{TRAIN_GRAD_RTOL} a leaf, the control above it")
    if not (math.isfinite(loss_k) and loss_err <= TRAIN_LOSS_RTOL
            and sound <= TRAIN_GRAD_RTOL) or zero:
        fail(f"phase {ph} step 0: kernels against {gate_run}: loss "
             f"{loss_err:.3g} > {TRAIN_LOSS_RTOL} or a leaf's gradient "
             f"{sound:.3g} > {TRAIN_GRAD_RTOL} of its norm, or a zero or "
             "non-finite gradient "
             f"in {zero}")
    if not control > TRAIN_GRAD_RTOL or not all(
            math.isfinite(x) for e in cerrs.values() for x in e):
        fail(f"phase {ph} control ({control_label}): worst leaf "
             f"{control:.3g} <= {TRAIN_GRAD_RTOL}, or a leaf's reading is "
             "not finite: the gate does not see it")
    log(f"phase {ph} step 0: against {gate_run} worst leaf {sound:.3g} <= "
        f"{TRAIN_GRAD_RTOL} < control {control:.3g}, loss {loss_err:.3g} "
        f"<= {TRAIN_LOSS_RTOL}"
        + (f", every {'/'.join(spec['nonzero'])} leaf's gradient non-zero"
           if spec["nonzero"] else "") + ": PASS")
    if any(n != want_step.get(k, 0) for k, n in counts.items()) \
            or routes0 != want_bwd:
        fail(f"phase {ph} step 0 gradients: launches {counts}, backward "
             f"routes {routes0}; want {want_step}, backward routes "
             f"{want_bwd}")
    del grads_k
    torch.cuda.empty_cache()

    # the training run
    if spec.get("optimizer"):
        opt = make_optimizer(spec["optimizer"], cosine_warmup(
            3e-4, warmup=min(500, TRAIN_STEPS // 10), total=TRAIN_STEPS))
    else:
        opt = default_optimizer(cfg, lr=3e-4, total_steps=TRAIN_STEPS)
    state = init_train_state(cfg, opt, device=dev, model=model)
    step_fn = make_train_step(cfg, opt, remat=True)
    plain_calls = {name: 0 for name in spec["plain_calls"]}

    def counted(name):
        fn = getattr(ref, name)

        def call(*a, **kw):
            plain_calls[name] += 1
            return fn(*a, **kw)
        return call

    rows, step_ms, records = [], [], []
    with contextlib.ExitStack() as stack:
        for name in plain_calls:
            stack.enter_context(mock.patch.object(ref, name, counted(name)))
        for i, batch in enumerate(batches):
            ops.reset_launch_counts()
            sync(dev)
            t0 = time.perf_counter()
            if i == TRAIN_STEPS - 1:
                done = []
                with profile_ranges(arch):
                    parts = serve_profile(
                        lambda: (done.append(step_fn(state, batch)),
                                 sync(dev)),
                        f"train step {i}", spec["parts"], ph,
                        ranges=spec.get("ranges"))
                state, m = done[0] if done else step_fn(state, batch)
            else:
                state, m = step_fn(state, batch)
            sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            routes = fwd_mod.route_counts()
            if any(n != want_step.get(k, 0) for k, n in counts.items()) \
                    or routes != want_fwd or bwd_routes() != want_bwd:
                fail(f"phase {ph} step {i}: launches {counts}, routes "
                     f"{routes}, backward routes {bwd_routes()}; want "
                     f"{want_step}, routes {want_fwd}, backward routes "
                     f"{want_bwd}")
            loss = float(m["loss"])
            if not math.isfinite(loss):
                fail(f"phase {ph} step {i}: loss {loss}")
            k_read, k_act = train_keys(i)
            nu = np.minimum(prng.randint_shaped(
                k_read, (mcfg.num_tasks,), 0, mcfg.tau + 1), i)
            mask = prng.bernoulli(prng.split(k_act)[1],
                                  mcfg.activation_rate, (mcfg.num_tasks,))
            if not (np.array_equal(m["mtl_nu"], nu)
                    and np.array_equal(m["mtl_mask"], mask)):
                fail(f"phase {ph} step {i}: staleness {m['mtl_nu']} / mask "
                     f"{m['mtl_mask']} are not the host replay's {nu} / "
                     f"{mask}")
            records.append((m["pooled"].cpu(), batch["task_ids"].cpu(),
                            batch["mtl_targets"].cpu()))
            rows.append(dict(step=i, loss=loss, lm_loss=float(m["lm_loss"]),
                             probe_loss=float(m["probe_loss"]),
                             mtl_v_norm=float(m["mtl_v_norm"]), ms=ms))
            if cfg.moe is not None:
                rows[-1]["aux_loss"] = float(m["aux_loss"])
            if "mtp_loss" in m:
                rows[-1]["mtp_loss"] = float(m["mtp_loss"])
            if not all(math.isfinite(v) for v in rows[-1].values()):
                fail(f"phase {ph} step {i}: a loss is not finite: "
                     f"{rows[-1]}")
            step_ms.append(ms)
    if any(plain_calls.values()):
        fail(f"phase {ph}: a plain version ran on the training path: "
             f"{plain_calls}")
    # the head's rounds replayed on the CPU from the card's pooled states
    cpu = mtl_head.init_mtl_state(cfg.d_model, mcfg)
    reg = mtl_head.get_regularizer(mcfg.reg_name)
    for i, (pooled, tids, tg) in enumerate(records):
        k_read, k_act = train_keys(i)
        v_hat, nu = mtl_head.stale_read(cpu, mcfg, k_read)
        p = reg.prox(v_hat, mtl_head.prox_threshold(mcfg))
        cpu, _ = mtl_head.amtl_head_update(cpu, pooled, tids, tg.float(),
                                           mcfg, k_act, read=(p, nu))
    ring = state.mtl.ring.cpu()
    head_err = ((ring - cpu.ring).abs().max()
                / cpu.ring.abs().max().clamp_min(1e-30)).item()
    if not (head_err <= HEAD_RTOL and state.mtl.ptr == cpu.ptr):
        fail(f"phase {ph}: the head's ring after {TRAIN_STEPS} steps is "
             f"{head_err:.3g} of its scale from the CPU replay (> "
             f"{HEAD_RTOL}) or its pointer differs")
    peak = torch.cuda.max_memory_allocated(dev)
    steady = statistics.median(step_ms[1:])
    tokens = t_batch * t_seq
    log(f"phase {ph} {TRAIN_STEPS} steps (B {t_batch}, S {t_seq}"
        + (f", {opt.name}" if spec.get("optimizer") else "") + "): losses "
        + ", ".join(f"{r['loss']:.6g} (lm {r['lm_loss']:.6g}, probe "
                    f"{r['probe_loss']:.6g}"
                    + "".join(f", {k[:-5]} {r[k]:.6g}"
                              for k in ("aux_loss", "mtp_loss") if k in r)
                    + ")" for r in rows)
        + f" (finite); step ms " + ", ".join(f"{ms:.1f}" for ms in step_ms)
        + f" (the first warms up, the last profiled); steady "
        f"{steady:.1f} ms, {tokens / (steady * 1e-3):.1f} {unit}/s; "
        f"launches a step exactly {spec['fwd']} {n_fwd} ({n_fwd - n_calls} "
        f"+ {n_fwd - n_calls} under remat"
        + (", the MTP block's once outside it" if cfg.mtp else "")
        + f", routes {want_fwd}) and {spec['bwd']} {n_calls}"
        + f" (routes {want_bwd})"
        + f", no plain {op}; staleness "
        "and masks bitwise the host replay; head ring against the CPU "
        f"replay {head_err:.3g} of its scale <= {HEAD_RTOL}; peak device "
        f"memory {peak / 1e9:.2f} GB, {(peak - held0) / 1e9:.2f} GB above "
        f"the {held0 / 1e9:.2f} GB allocated when the phase began; card "
        f"{card}: PASS")
    del state, model, batches, data, records
    torch.cuda.empty_cache()
    ssd = None
    dev_ms = parts.get("device_ms")
    if not (isinstance(dev_ms, float) and dev_ms > 0):
        dev_ms = None
    if "mamba" in cfg.layer_kinds:
        ssd = ssd_times(cfg, dev, seed)
        log(f"phase {ph} {arch}'s SSD alone (B, L, H, P, N, chunk "
            f"{ssd['shape']}, x bf16, plain PyTorch): forward "
            f"{ssd['fwd_ms']:.2f} ms, forward and backward "
            f"{ssd['fwd_bwd_ms']:.2f} ms ({ssd['fwd_bwd_peak_bytes'] / 1e9:.2f}"
            f" GB above the inputs), so {ssd['mixers']} mixers x (forward + "
            f"forward and backward) {ssd['step_ms']:.1f} ms a step"
            + ("" if dev_ms is None else
               f", {100 * ssd['step_ms'] / dev_ms:.1f}% of the profiled "
               f"step's {dev_ms:.1f} device ms"))
    if dev_ms is not None:
        log(f"phase {ph} {arch} train step {TRAIN_STEPS - 1}: the backward "
            f"kernels ({spec['bwd']}) {parts[spec['bwd']]['ms']:.1f} ms, "
            f"{100 * parts[spec['bwd']]['share']:.1f}% of its "
            f"{dev_ms:.1f} device ms")
    card_cpu = train_card_cpu(arch, seed, dev, ph) if spec.get("card_cpu") \
        else None
    free1, _ = torch.cuda.mem_get_info(dev)
    seconds = time.perf_counter() - t_phase
    log(f"phase {ph}: {seconds:.1f} s; {free1 / 1e9:.1f} GB free after")
    launches = {k: n * TRAIN_STEPS for k, n in want_step.items()}
    launches["fwd_routes"] = {r: n * TRAIN_STEPS for r, n in want_fwd.items()}
    launches["bwd_routes"] = {r: n * TRAIN_STEPS for r, n in want_bwd.items()}
    out = dict(rows=rows, step_ms=step_ms, steady_ms=steady,
               tokens_per_s=tokens / (steady * 1e-3), unit=unit,
               peak_bytes=peak, phase_peak_bytes=peak - held0,
               loss_err=loss_err, grad_err=sound,
               gate="held" if use_held else "plain",
               plain_grad_err=max(e[1] for e in errs.values()),
               control=control,
               head_err=head_err, parts=parts, launches=launches,
               seconds=seconds)
    if cfg is not published:
        out.update(layers=n_layers, periods=cfg.num_periods,
                   published_layers=published.num_layers,
                   published_periods=published.num_periods)
    if noise is not None:
        out["plain_noise"] = max(e[1] for e in noise.values())
    if ssd is not None:
        out["ssd"] = ssd
    if card_cpu is not None:
        out["card_vs_cpu"] = card_cpu
    if spec.get("optimizer"):
        out["optimizer"] = opt.name
    return out


def named(path: str, names) -> bool:
    """Whether a leaf's dotted path is one of `names`: a name, a dotted
    suffix of the path, or (ending in ".") a prefix of it."""
    return any(path.startswith(n) if n.endswith(".") else
               (path == n or path.endswith("." + n)) for n in names)


# The reduced config's step-0 gradients on the card against the port's
# CPU run of the same weights and batch (float32, TF32 off): the card's
# gate for the routed MoE's backward, deepseek's shared expert and the aux
# loss, which no kernel covers and which cannot train at full width.
TRAIN_CARD_CPU_SEQ = 64


def train_card_cpu(arch: str, seed: int, dev, ph: int) -> dict:
    """`arch`'s reduced config (float32) with the same weights on the card
    and on the CPU: step 0's loss (LM, aux and MTP included, with the
    probe loss at the zero head's read) and every leaf's gradient, by max
    |diff| over max |grad| <= CARD_CPU_RTOL."""
    import torch
    from repro_torch.launch import train as train_mod
    from repro_torch.models import LM, init_params
    cfg = train_mod.train_config(arch, reduced=True)
    cpu_model = init_params(cfg, seed=seed, device="cpu")
    card_model = LM(cfg, _to_device(cpu_model.tree(), dev))
    batch = next(train_mod.batches_for(cfg, TRAIN_CARD_CPU_SEQ, 2,
                                       seed=seed + 1))
    runs = {}
    for name, model, d in (("cpu", cpu_model, torch.device("cpu")),
                           ("card", card_model, dev)):
        model.requires_grad_(True)
        p0 = torch.zeros((cfg.d_model, cfg.mtl.num_tasks),
                         dtype=torch.float32, device=d)
        loss, grads = train_grads(
            model, {k: torch.as_tensor(v, device=d)
                    for k, v in batch.items()}, cfg, p0)
        runs[name] = loss, {k: g.cpu() for k, g in grads.items()}
    (l_cpu, g_cpu), (l_card, g_card) = runs["cpu"], runs["card"]
    errs = {k: e[0] for k, e in leaf_errs(g_card, g_cpu).items()}
    worst = max(errs, key=errs.get)
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    live = sum(bool(g.any()) for g in g_cpu.values())
    if set(g_card) != set(g_cpu) or not loss_err <= CARD_CPU_RTOL \
            or not errs[worst] <= CARD_CPU_RTOL:
        fail(f"phase {ph} {arch} reduced card vs CPU: loss {loss_err:.3g}, "
             f"worst leaf {worst} {errs[worst]:.3g} > {CARD_CPU_RTOL}")
    log(f"phase {ph} {arch} reduced ({cfg.num_layers} layers"
        + (" and the MTP block" if cfg.mtp else "") + f", d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}, float32, TF32 off) card vs the port's CPU run of "
        f"the same weights, B 2 x S {TRAIN_CARD_CPU_SEQ}: step 0's loss "
        f"{loss_err:.3g}, {len(g_cpu)} leaves' gradients ({live} non-zero), "
        f"worst {worst} {errs[worst]:.3g}, all <= {CARD_CPU_RTOL} of max "
        "|grad|: PASS")
    return dict(loss=loss_err, worst_leaf=errs[worst], leaves=len(g_cpu))


# ---------------------------------------------------------------- phase 31 --

ENCODER_ARCH = "hubert-xlarge"
# The encoder's kernels in a profile: the flash routes and cuBLAS.
ENCODER_PARTS = {**FLASH_PARTS, **CUBLAS_PARTS}
ENCODER_REPS = 5


def encoder_card_cpu(seed: int, dev, ph: int) -> dict:
    """The reduced hubert-xlarge (float32) with the same weights, mask_emb
    drawn, on the card and on the CPU: `encode`'s logits at every position
    and `prefill`'s last-position logits and cache over B 2 x 200 frames
    with a 30 % mask, each by max |diff| over max |value| <=
    CARD_CPU_RTOL."""
    import torch
    from repro_torch.interop import kv_cache_to_numpy
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_encode_step, make_prefill_step
    from repro_torch.models import LM, init_params
    cfg = train_mod.train_config(ENCODER_ARCH, reduced=True)
    cpu_model = init_params(cfg, seed=seed, device="cpu")
    wake_inert_leaves(cpu_model, seed)
    card_model = LM(cfg, _to_device(cpu_model.tree(), dev))
    batch = next(train_mod.batches_for(cfg, CARD_CPU_PROMPT, 2, seed=seed))
    runs = {}
    for name, model, d in (("cpu", cpu_model, torch.device("cpu")),
                           ("card", card_model, dev)):
        feats = torch.as_tensor(batch["features"], device=d)
        mask = torch.as_tensor(batch["mask"], device=d)
        logits = make_encode_step(cfg)(model, feats, mask).cpu()
        last, cache = make_prefill_step(cfg)(model, feats)
        runs[name] = (logits, last.cpu(), kv_cache_to_numpy(cache))
    (lc, pc, cc), (lk, pk, ck) = runs["cpu"], runs["card"]
    errs = [rel_err(lk, lc), rel_err(pk, pc)]
    leaf_errs = {k: float(np.abs(ck[k] - cc[k]).max()
                          / max(np.abs(cc[k]).max(), 1e-30)) for k in cc}
    worst_leaf = max(leaf_errs, key=leaf_errs.get)
    if set(ck) != set(cc) or not max(errs) <= CARD_CPU_RTOL \
            or not leaf_errs[worst_leaf] <= CARD_CPU_RTOL:
        fail(f"{ENCODER_ARCH} reduced card vs CPU: encode {errs[0]:.3g}, "
             f"prefill {errs[1]:.3g}, worst cache leaf {worst_leaf} "
             f"{leaf_errs[worst_leaf]:.3g} > {CARD_CPU_RTOL}")
    log(f"phase {ph} {ENCODER_ARCH} reduced ({cfg.num_layers} layer, "
        f"d_model {cfg.d_model}, float32, TF32 off) card vs the port's CPU "
        f"run of the same weights, B 2 x {CARD_CPU_PROMPT} frames: encode "
        f"logits {errs[0]:.3g}, prefill's last position {errs[1]:.3g}, "
        f"{len(cc)} cache leaves, worst {worst_leaf} "
        f"{leaf_errs[worst_leaf]:.3g}, all <= {CARD_CPU_RTOL} of max "
        "|value|: PASS")
    return dict(encode=errs[0], prefill=errs[1],
                worst_leaf=leaf_errs[worst_leaf])


def encoder_phase(dev, seed: int, card: str) -> dict:
    """Phase 31: hubert-xlarge's encoder forward at its published width,
    bf16, through `launch.steps.make_encode_step` (every position's
    logits) over ENCODER_BATCH x ENCODER_SEQ frames of `batches_for`'s
    features and mask (mask_emb drawn from the seed): launches and routes
    (one sm90 call a layer, no other kernel), frames/s, device time by
    kernel; the logits against the plain run (ops.mha patched to
    ref.mha_ref) at max(SERVE_RTOL, NOISE_FACTOR x a second plain
    attention's distance); `make_prefill_step`'s last position against
    the encoder's unmasked run; a float32 run at SERVE_F32_RTOL; and the
    reduced config on the card against the CPU."""
    from unittest import mock
    import torch
    from repro_torch.kernels import flash_attention as k_flash
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_encode_step, make_prefill_step
    from repro_torch.models import init_params
    ph = 31
    t_phase = time.perf_counter()
    cfg = train_mod.train_config(ENCODER_ARCH, reduced=False)
    b, s = ENCODER_BATCH, ENCODER_SEQ
    model = init_params(cfg, seed=seed, device=dev)
    woken = wake_inert_leaves(model, seed)
    batch = next(train_mod.batches_for(cfg, s, b, seed=seed + 1))
    feats = torch.as_tensor(batch["features"], device=dev)
    mask = torch.as_tensor(batch["mask"], device=dev)
    sync(dev)
    log(f"phase {ph} {ENCODER_ARCH}: {model.num_params() / 1e6:.1f}M "
        f"parameters ({cfg.num_layers} layers, d_model {cfg.d_model}, hd "
        f"{cfg.head_dim}, {cfg.dtype}); {', '.join(woken)} drawn from the "
        f"seed; B {b} x {s} frames, {int(mask.sum())} masked")
    encode = make_encode_step(cfg)
    encode(model, feats[:, :128], mask[:, :128])          # warm up
    ops.reset_launch_counts()
    logits = encode(model, feats, mask)
    sync(dev)
    counts, routes = ops.launch_counts(), k_flash.route_counts()
    n = cfg.num_layers
    want_r = {"sm90": n, "split": 0, "simt": 0}
    if counts["flash_attention"] != n or routes != want_r \
            or any(c for k, c in counts.items() if k != "flash_attention"):
        fail(f"phase {ph} {ENCODER_ARCH}: launches {counts}, routes "
             f"{routes}; want flash_attention {n}, routes {want_r}")
    if tuple(logits.shape) != (b, s, cfg.vocab_size) \
            or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()):
        fail(f"phase {ph} {ENCODER_ARCH}: logits of shape "
             f"{tuple(logits.shape)} and dtype {logits.dtype}, or not "
             "finite")
    secs = []
    for _ in range(ENCODER_REPS):
        sync(dev)
        t0 = time.perf_counter()
        encode(model, feats, mask)
        sync(dev)
        secs.append(time.perf_counter() - t0)
    steady = statistics.median(secs)
    frames_s = b * s / steady
    prof = serve_profile(lambda: (encode(model, feats, mask), sync(dev)),
                         f"encoder (B {b}, S {s})", ENCODER_PARTS, ph)
    log(f"phase {ph} encoder forward: {steady * 1e3:.2f} ms a call (median "
        f"of {ENCODER_REPS}, host clock), {frames_s:.1f} frames/s; launches "
        f"a call flash_attention {n}, routes {routes} (hd {cfg.head_dim} "
        f"at {k_flash.sm90_width(cfg.head_dim)} columns); card {card}")
    # prefill: the last position and the cache, no frame masked
    ops.reset_launch_counts()
    last, cache = make_prefill_step(cfg)(model, feats)
    unmasked = encode(model, feats)
    sync(dev)
    leaves = [t for c in cache.values() for kv in c.values() for t in kv
              if t is not None]      # a model-dtype KVCache's scales
    e_prefill = rel_err(last, unmasked[:, -1:])
    if k_flash.route_counts()["sm90"] != 2 * n \
            or tuple(last.shape) != (b, 1, cfg.vocab_size) \
            or any(tuple(t.shape) != (n, b, s, cfg.num_kv_heads,
                                      cfg.head_dim) for t in leaves) \
            or not e_prefill <= SERVE_RTOL:
        fail(f"phase {ph} prefill: routes {k_flash.route_counts()}, last "
             f"logits {tuple(last.shape)}, cache "
             f"{[tuple(t.shape) for t in leaves]}, against the encoder's "
             f"last position {e_prefill:.3g} > {SERVE_RTOL}")
    del cache, leaves, unmasked
    # the plain run, and a second plain attention for the bf16 noise
    ops.reset_launch_counts()
    with mock.patch.object(ops, "mha", ref.mha_ref):
        plain = encode(model, feats, mask)
    with mock.patch.object(ops, "mha", mha_dense_plain):
        second = encode(model, feats, mask)
    if ops.launch_counts()["flash_attention"]:
        fail(f"phase {ph}: the plain runs launched the kernel")
    noise = rel_err(second, plain)
    tol = max(SERVE_RTOL, NOISE_FACTOR * noise)
    err = rel_err(logits, plain)
    if not err <= tol or not bool(torch.isfinite(plain).all()):
        fail(f"phase {ph} {ENCODER_ARCH}: kernel against plain logits "
             f"{err:.3g} > {tol:.3g} of max|logits| (the second plain "
             f"attention {noise:.3g} from the first)")
    gate = "SERVE_RTOL" if tol == SERVE_RTOL else \
        f"{NOISE_FACTOR} x the two plain runs' distance"
    log(f"phase {ph} {ENCODER_ARCH}: every position's logits against the "
        f"plain mha run on the same weights, max |diff| / max|logits| "
        f"(max|logits| {float(plain.abs().max()):.3g}): {err:.3g} <= "
        f"{tol:.3g} ({gate}; the second plain attention, "
        f"mha_dense_plain, {noise:.3g} from mha_ref); prefill's last "
        f"position against the unmasked encoder's {e_prefill:.3g}: PASS")
    del plain, second, logits
    # float32, every layer
    tree = model.tree()
    del model
    torch.cuda.empty_cache()
    model32, cfg32, keep, _ = float32_model(tree, cfg)
    del tree
    encode32 = make_encode_step(cfg32)
    ops.reset_launch_counts()
    lk = encode32(model32, feats, mask)
    if k_flash.route_counts() != {"sm90": 0, "split": 0,
                                  "simt": cfg32.num_layers}:
        fail(f"phase {ph} float32: routes {k_flash.route_counts()}, want "
             f"simt {cfg32.num_layers}")
    with mock.patch.object(ops, "mha", ref.mha_ref):
        lp = encode32(model32, feats, mask)
    e32 = rel_err(lk, lp)
    if not e32 <= SERVE_F32_RTOL or not bool(torch.isfinite(lk).all()):
        fail(f"phase {ph} float32: kernel against plain logits {e32:.3g} > "
             f"{SERVE_F32_RTOL} of max|logits|")
    log(f"phase {ph} {ENCODER_ARCH} float32 encoder (B {b}, S {s}, TF32 "
        f"off, {cfg32.num_layers} layers, {cfg32.num_layers} simt "
        f"launches): kernel against plain within {e32:.3g} of max|logits| "
        f"<= {SERVE_F32_RTOL}: PASS")
    del model32, lk, lp
    torch.cuda.empty_cache()
    card_cpu = encoder_card_cpu(seed, dev, ph)
    seconds = time.perf_counter() - t_phase
    log(f"phase {ph}: {seconds:.1f} s")
    return dict(counts=counts, routes=routes, steady_ms=steady * 1e3,
                frames_per_s=frames_s, err=err, tol=tol, noise=noise,
                prefill_err=e_prefill, e32=e32,
                profile={k: v for k, v in prof.items() if k != "top"},
                card_vs_cpu=card_cpu, seconds=seconds)


# ------------------------------------------------------------- resources --

def host_resources() -> dict:
    """Free bytes under build/ and the host's MemAvailable; fails before
    any phase runs when either is short of what the phases need."""
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    free = shutil.disk_usage(build).free
    with open("/proc/meminfo") as f:
        mem = {line.split(":")[0]: int(line.split()[1]) * 1024 for line in f}
    avail = mem["MemAvailable"]
    log(f"host: {free / 1e9:.1f} GB free under {build} (the checkpoints need "
        f"{SERVE_FREE_BYTES / 1e9:.0f} GB), MemAvailable "
        f"{avail / 2 ** 30:.1f} GiB of {mem['MemTotal'] / 2 ** 30:.1f} GiB "
        f"(the phases need {HOST_FREE_BYTES / 2 ** 30:.0f} GiB)")
    short = []
    if free < SERVE_FREE_BYTES:
        short.append(f"disk under {build}: {free / 1e9:.1f} GB free, "
                     f"{SERVE_FREE_BYTES / 1e9:.0f} GB needed")
    if avail < HOST_FREE_BYTES:
        short.append(f"host memory: {avail / 2 ** 30:.1f} GiB available, "
                     f"{HOST_FREE_BYTES / 2 ** 30:.0f} GiB needed")
    if short:
        fail("short of resources before any phase: " + "; ".join(short))
    return {"free_bytes": free, "mem_available": avail}


# ---------------------------------------------------------------- phase 22 --

def lockstep_spec(dev, seed: int, v0, key, servers: list) -> dict:
    """A `launch.serve_lockstep` spec at the engine cells' width: the
    ragged store of `make_store` (each rank draws it and keeps its block),
    the phase's request batches, arrays back as digests."""
    return dict(device=dev.type, problem=dict(
        store_seed=seed, t=T, d=D, lo=COHORT_LO, hi=COHORT_HI, lam=LAM),
        v0=v0, key=key, digest=True, keep_snapshots=LOCK_DIST_BATCHES,
        traffic=dict(seed=seed, batches=LOCK_BATCHES, rows=SERVE_ROWS),
        servers=servers)


def lock_compare(label: str, got: dict, want: dict,
                 k: int | None = None) -> None:
    """Receipts, predictions, steps, snapshots and the state of `got`
    bitwise `want`'s (its last k of each where k is given)."""
    def tail(x):
        return x if k is None else x[-k:]
    for name in ("receipts", "preds", "ran"):
        if got[name] != tail(want[name]):
            fail(f"{label}: {name} differ from the one-rank server's")
    def digests(snaps):
        return [(e, x if isinstance(x, str) else
                 hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest())
                for e, x in snaps]
    if digests(got["snapshots"]) != digests(tail(want["snapshots"])):
        fail(f"{label}: the snapshots differ from the one-rank server's")
    if got["state"] != want["state"]:
        fail(f"{label}: the engine state differs from the one-rank server's")


def lock_launches(label: str, res: dict, dev) -> None:
    """Each kernel of the path launched exactly as the rank's events call
    for, and no other (on the card: the CPU launches none)."""
    if dev.type != "cuda":
        return
    want = {k: res["expected"].get(k, 0) for k in res["launches"]}
    if res["launches"] != want:
        fail(f"{label}: launches {res['launches']}, the rank's events call "
             f"for {want}")


def lockstep_serve_phase(dev, seed: int, card: str, worlds: list) -> dict:
    """Phase 22: the learn-while-serve AMTLServer on LOCK_RANKS ranks
    stepping in lockstep on this card (22a cooperative, 22c threaded with
    a crash on rank 1, 22d the distributed prox, in the first of `worlds`;
    22b the resume in the second), each against the one-rank server in
    this process; the one-rank runs are freed before the worlds' calls."""
    import gc
    import torch
    from repro_torch.core import prng
    from repro_torch.launch import serve_lockstep

    t_phase = time.perf_counter()
    if any(w.n != LOCK_RANKS for w in worlds):
        fail(f"phase 22: worlds of {[w.n for w in worlds]} ranks, want "
             f"{LOCK_RANKS}")
    root = ROOT / "build" / "serve_ckpt" / "lockstep"
    shutil.rmtree(root, ignore_errors=True)
    v0 = (np.float32(0.01) * np.random.default_rng(seed + 5).standard_normal(
        (D, T), dtype=np.float32))
    key = prng.key_from_seed(seed)
    cfg = configs(T)[0]
    shard = cfg._replace(engine="sharded")
    dist = shard._replace(prox_mode="distributed")
    sc = {k: v for k, v in SERVE_CFG.items() if k != "checkpoint_every"}
    # 22c's chunk log is held to the cooperative loop's, so its budget
    # must not follow the predict latencies the SLO controller reads
    unslo = dict(sc, slo_ms=None)
    serve = [("serve", i) for i in range(LOCK_BATCHES)]
    saved = serve[:LOCK_SAVE_AT] + [("checkpoint",)] + serve[LOCK_SAVE_AT:]
    fed = [("submit", i) for i in range(LOCK_THREADED)]
    asks = [("ask", i) for i in range(LOCK_BATCHES)]

    # the one-rank server (batch engine) in this process: the script (its
    # store by the ranks' blocks), the threaded feedback's cooperative
    # drain and frozen serving
    t0 = time.perf_counter()
    ref, drain, frozen1 = serve_lockstep.session(lockstep_spec(
        dev, seed, v0, key, [
            dict(cfg=cfg._asdict(), serve=sc, ops=serve, blocks=LOCK_RANKS),
            dict(cfg=cfg._asdict(), serve=unslo, ops=fed + [("drain",)],
                 store=False),
            dict(cfg=cfg._asdict(), serve=dict(sc, learning=False),
                 ops=asks)]))
    one_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    cap = ref["block"][0][1]
    n_local = T // LOCK_RANKS

    # the world: 22a, 22c, 22d and frozen serving
    t0 = time.perf_counter()
    out = worlds[0].run(serve_lockstep.session, lockstep_spec(
        dev, seed, v0, key, [
            dict(cfg=shard._asdict(), serve=dict(sc, ckpt_dir=str(root)),
                 ops=saved),
            dict(cfg=shard._asdict(), serve=dict(unslo, restart_limit=2,
                                                 restart_backoff_s=0.01),
                 faults={1: dict(crash_on_chunks={1})},
                 ops=fed + [("start",),
                            ("predict_while", LOCK_PREDICTS, LOCK_THREADED),
                            ("stop", True)], store=False),
            dict(cfg=dist._asdict(), serve=sc, ops=serve[:LOCK_DIST_BATCHES],
                 store=False),
            dict(cfg=shard._asdict(), serve=dict(sc, learning=False),
                 ops=asks)]), timeout=SHARD_WORLD_TIMEOUT_S)
    world_s = time.perf_counter() - t0

    # 22a: cooperative, bitwise the one-rank server
    for r, res in enumerate(out):
        run = res[0]
        lock_compare(f"22a rank {r}", run, ref)
        if run["store"] != ref["store_blocks"][r] \
                or run["counts"] != ref["counts"]:
            fail(f"22a rank {r}: its store shard is not its block of the "
                 "one-rank store")
        if run["block"] != ((n_local, cap, D), (n_local, cap, D), n_local):
            fail(f"22a rank {r}: holds {run['block']} (problem, engine, "
                 f"store tasks), not its {n_local} tasks alone")
        lock_launches(f"22a rank {r}", run, dev)
    r0 = out[0][0]
    log(f"phase 22a {LOCK_RANKS} ranks, cooperative: {LOCK_BATCHES} batches "
        f"of {SERVE_ROWS} predictions + {SERVE_ROWS} labelled rows, chunks "
        f"{sorted(set(r0['chunk_log']))}, a checkpoint after batch "
        f"{LOCK_SAVE_AT}; receipts, predictions, {len(r0['snapshots'])} "
        f"snapshots, the chunk log and the state bitwise the one-rank "
        f"server's; each rank's store shard its block of the one-rank store "
        f"(capacity {ref['block'][0][1]}); each rank holds (problem, engine, "
        f"store tasks) {r0['block']}; launches by rank "
        f"{[res[0]['launches'] for res in out]}, each the count its events "
        f"call for [{card}]: PASS")

    # 22b: resume in the other world (ranks that never ran the server
    # that saved), and at one rank, from the 2-rank record
    t0 = time.perf_counter()
    again = worlds[1].run(serve_lockstep.session, lockstep_spec(
        dev, seed, v0, key, [dict(cfg=shard._asdict(),
                                  serve=dict(sc, ckpt_dir=str(root)),
                                  resume=True, ops=serve[LOCK_SAVE_AT:])]),
        timeout=SHARD_WORLD_TIMEOUT_S)
    world_s += time.perf_counter() - t0
    k = LOCK_BATCHES - LOCK_SAVE_AT
    for r, res in enumerate(again):
        run = res[0]
        lock_compare(f"22b rank {r}", run, ref, k)
        if run["store"] != ref["store_blocks"][r] or run["start_event"] \
                != ref["snapshots"][LOCK_SAVE_AT - 1][0]:
            fail(f"22b rank {r}: resumed at event {run['start_event']} with "
                 "another store shard than the uninterrupted server's")
        lock_launches(f"22b rank {r}", run, dev)
    t0 = time.perf_counter()
    one_back = serve_lockstep.session(lockstep_spec(dev, seed, v0, key, [
        dict(cfg=cfg._asdict(), serve=dict(sc, ckpt_dir=str(root)),
             resume=True, ops=serve[LOCK_SAVE_AT:])]))[0]
    one_s += time.perf_counter() - t0
    lock_compare("22b one rank", one_back, ref, k)
    if one_back["store"] != ref["store"]:
        fail("22b one rank: the resumed store is not the uninterrupted one")
    shutil.rmtree(root, ignore_errors=True)
    def gb(peak):
        return f"{peak[0] / 1e9:.2f} GB (+{peak[1] / 1e9:.2f})"
    log(f"phase 22b resume from the {LOCK_RANKS}-rank record at event "
        f"{again[0][0]['start_event']}: in another world of {LOCK_RANKS} "
        f"({again[0][0]['build_s']:.2f} s; host peak (and rise over the "
        f"call's start) by rank "
        f"{', '.join(gb(res[0]['build_host_peak']) for res in again)}) and "
        f"at one rank ({one_back['build_s']:.2f} s; host peak "
        f"{gb(one_back['build_host_peak'])}), {k} batches: "
        f"predictions, snapshots, state and store bitwise the uninterrupted "
        f"server's [{card}]: PASS")

    # 22c: threaded, a scripted crash on rank 1 alone
    for r, res in enumerate(out):
        run = res[1]
        health = run["stats"]["health"]
        if run["chunk_log"] != drain["chunk_log"] \
                or run["state"] != drain["state"]:
            fail(f"22c rank {r}: the drained chunk log or state differs "
                 "from the cooperative one-rank loop's")
        if health["learner_restarts"] != (1 if r == 1 else 0) \
                or run["stops"] != [sum(drain["chunk_log"])]:
            fail(f"22c rank {r}: restarts {health['learner_restarts']}, "
                 f"stop {run['stops']}")
        lock_launches(f"22c rank {r}", run, dev)
    if out[0][1]["learner_threads"] != (1, False):
        fail(f"22c: rank 0's collectives came from "
             f"{out[0][1]['learner_threads']} (threads, main among them)")
    rec = out[1][1]["stats"]["health"]["recovery_ms"]
    log(f"phase 22c threaded: the learners drained {out[0][1]['chunk_log']} "
        f"while every rank predicted {LOCK_PREDICTS} batches, a scripted "
        f"crash on rank 1 alone healed ({rec[0]:.2f} ms), rank 0's "
        f"collectives from its learner thread alone; the chunk log and the "
        f"state bitwise the cooperative one-rank loop's [{card}]: PASS")

    # 22d: the distributed prox against the script's first batches
    worst, k = 0.0, LOCK_DIST_BATCHES
    for r, res in enumerate(out):
        run = res[2]
        for name in ("receipts", "ran", "streams"):
            if run[name] != ref[name][:k]:
                fail(f"22d rank {r}: {name} differ from the one-rank "
                     "server's (the streams: the event stream)")
        if run["chunk_log"] != ref["chunk_log"][:len(run["chunk_log"])]:
            fail(f"22d rank {r}: the chunk log differs")
        for (e, x), (f, y) in zip(run["snapshots"], ref["snapshots"][:k],
                                  strict=True):
            err = float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
            worst = max(worst, err)
            if e != f or not err <= SHARD_RTOL:
                fail(f"22d rank {r}: snapshot at event {e} off by {err:.3g} "
                     f"> {SHARD_RTOL} of scale")
        lock_launches(f"22d rank {r}", run, dev)
    log(f"phase 22d distributed prox, {LOCK_DIST_BATCHES} batches: chunks, "
        f"receipts and the event stream bitwise, every snapshot within "
        f"{worst:.3g} <= {SHARD_RTOL} of scale of the one-rank server's "
        f"[{card}]: PASS")

    # the numbers (2 ranks share this card and its host: not scale-out)
    def ckpt(res):
        c = res["ckpts"][0]
        return [c["s"], c["bytes"], *c["host_peak"]]

    def spent(res):
        """(set-up, each server's) seconds of a session"""
        return [res[0]["setup_s"]] + [run["total_s"] for run in res]
    wire = [res[0]["wire"] for res in out]
    ranks = [f"rank {r}" for r in range(LOCK_RANKS)]
    metrics = {
        "card": card,
        "requests_per_sec_learning": {
            "1": ref["requests"] / ref["learn_s"],
            str(LOCK_RANKS): r0["requests"] / r0["learn_s"]},
        "requests_per_sec_frozen": {
            "1": frozen1["requests"] / frozen1["ask_s"],
            str(LOCK_RANKS): out[0][3]["requests"] / out[0][3]["ask_s"]},
        "fold_s_mean": {n: w["fold_s"] / w["folds"]
                        for n, w in zip(ranks, wire)},
        "fold_bytes_mean": {n: w["fold_bytes"] / w["folds"]
                            for n, w in zip(ranks, wire)},
        "gather_ms_mean": 1e3 * wire[0]["gather_s"] / wire[0]["gathers"],
        "checkpoint_s_bytes_host_peak": {
            n: ckpt(res[0]) for n, res in zip(ranks, out)},
        "resume_s_host_peak": {
            "1": [one_back["build_s"], *one_back["build_host_peak"]],
            **{n: [res[0]["build_s"], *res[0]["build_host_peak"]]
               for n, res in zip(ranks, again)}},
        # ru_maxrss: a spawned rank's starts at its parent's peak at the
        # spawn (Linux carries it through fork and exec) and spans phase
        # 21's session in the same rank; the sampled peak is its own
        "max_rss": {"parent": serve_lockstep.max_rss_bytes(), **{
            n: res[-1]["max_rss"] for n, res in zip(ranks, out)}},
        "host_peak_sampled": {
            **{f"{n} world": res[0]["servers_host_peak"]
               for n, res in zip(ranks, out)},
            **{f"{n} resume": res[0]["servers_host_peak"]
               for n, res in zip(ranks, again)}},
        "device_peak": {n: max(run["device_peak"] for run in res)
                        for n, res in zip(ranks, out)},
        "one_rank_s": one_s, "worlds_s": world_s,
        "session_s": {"one rank": spent([ref, drain, frozen1]),
                      "resume at one rank": spent([one_back]),
                      **{f"{n} world": spent(res)
                         for n, res in zip(ranks, out)},
                      **{f"{n} resume": spent(res)
                         for n, res in zip(ranks, again)}},
        "launches": {"1": ref["launches"],
                     **{n: res[0]["launches"] for n, res in
                        zip(ranks, out)}},
        "seconds": time.perf_counter() - t_phase,
    }
    log(f"phase 22 serving ({card}; {LOCK_RANKS} ranks share this card's "
        f"SMs and its host, and the collectives go through host memory: not "
        f"scale-out numbers): requests/s learning "
        f"{metrics['requests_per_sec_learning']['1']:.1f} at one rank, "
        f"{metrics['requests_per_sec_learning'][str(LOCK_RANKS)]:.1f} at "
        f"{LOCK_RANKS}; frozen {metrics['requests_per_sec_frozen']['1']:.1f}"
        f" and {metrics['requests_per_sec_frozen'][str(LOCK_RANKS)]:.1f}; "
        f"fold a boundary "
        + ", ".join(f"{n} {metrics['fold_s_mean'][n]:.3f} s / "
                    f"{metrics['fold_bytes_mean'][n] / 1e9:.3f} GB uploaded"
                    for n in ranks)
        + f"; the flip's gather {metrics['gather_ms_mean']:.3f} ms; a "
          f"checkpoint "
        + ", ".join(f"{n}: {v[0]:.2f} s / {v[1] / 1e9:.3f} GB, host peak "
                    f"{gb(v[2:])}" for n, v in
                    metrics["checkpoint_s_bytes_host_peak"].items())
        + "; ru_maxrss "
        + ", ".join(f"{n} {v / 1e9:.2f} GB"
                    for n, v in metrics["max_rss"].items())
        + " (a rank's from the parent's at its spawn, phase 21's session "
          "in it); each rank's own sampled peak "
        + ", ".join(f"{n} {v / 1e9:.2f} GB"
                    for n, v in metrics["host_peak_sampled"].items())
        + "; device peak "
        + ", ".join(f"{n} {v / 1e9:.2f} GB"
                    for n, v in metrics["device_peak"].items()))
    log(f"phase 22 one rank {one_s:.1f} s, the worlds' calls "
        f"{world_s:.1f} s with set-up (the ranks up since phase 20; "
        f"{metrics['seconds']:.1f} s); by session "
        f"(set-up, then each server's s): "
        + "; ".join(f"{n} " + ", ".join(f"{x:.1f}" for x in v)
                    for n, v in metrics["session_s"].items()) + ": PASS")
    log("lockstep_serving " + json.dumps(metrics))
    return metrics


# ---------------------------------------------------------------- phase 23 --

def twin_close(label: str, got, want, rule) -> None:
    """`got` (the card's) against `want` (the CPU's) under a rule: None
    exact, ("rel", tol) or ("abs", tol)."""
    if rule is None:
        ok = got == want
    elif rule[0] == "rel":
        ok = abs(got - want) <= rule[1] * abs(want)
    else:
        ok = abs(got - want) <= rule[1]
    if not ok:
        fail(f"23 {label}: the card's {got!r} against the CPU's {want!r} "
             f"({'exact' if rule is None else rule})")


def twins_phase(dev, card: str) -> dict:
    """Phase 23: the twins of examples/quickstart.py and hospitals_async.py
    on the card against their CPU runs, with the kernels they launch."""
    from repro_torch.kernels import ops
    from repro_torch.launch import hospitals_async, quickstart
    t0 = time.perf_counter()
    obj, res, drift = (("rel", TWIN_OBJ_RTOL), ("abs", TWIN_RESIDUAL_ATOL),
                       ("rel", TWIN_DRIFT_RTOL))
    rules = {
        "quickstart": {"fista": obj, "smtl": obj, "amtl": obj,
                       "residual": res, "gap": res},
        "hospitals_async": {"stream_objective": obj, "drift": drift},
    }
    launches = {}
    for name, twin in (("quickstart", quickstart),
                       ("hospitals_async", hospitals_async)):
        cpu = twin.main(["--device", "cpu"])
        sync(dev)
        ops.reset_launch_counts()
        got = twin.main(["--device", dev.type])
        sync(dev)
        launches[name] = {k: v for k, v in ops.launch_counts().items() if v}
        for k, want in cpu.items():
            rule = rules[name].get(k)
            if isinstance(want, tuple) and rule is not None:
                for i, (a, b) in enumerate(zip(got[k], want)):
                    twin_close(f"{name} {k}[{i}]", a, b, rule)
            else:
                twin_close(f"{name} {k}", got[k], want, rule)
        flags = [k for k, v in got.items() if v is True]
        log(f"phase 23 {name} twin on the card against its CPU run: "
            f"objectives within {TWIN_OBJ_RTOL} relative, the residual and "
            f"the gap within {TWIN_RESIDUAL_ATOL}, the drift within "
            f"{TWIN_DRIFT_RTOL}, every other number exact (the float64 "
            f"simulator's times and speedup too); bitwise claims {flags} "
            f"held; launches {launches[name]} [{card}]: PASS")
    need = {"quickstart": ("amtl_event", "lstsq_grad"),
            "hospitals_async": ("amtl_event_batch", "lstsq_grad_sampled",
                                "lstsq_grad")}
    for name, kernels in need.items():
        for k in kernels:
            if dev.type == "cuda" and not launches[name].get(k):
                fail(f"23 {name}: {k} never launched on the card")
    seconds = time.perf_counter() - t0
    log(f"phase 23 twins: {seconds:.1f} s: PASS")
    return {"launches": launches, "seconds": seconds}


# ---------------------------------------------------------------- phase 39 --

# granite-8b (configs/granite_8b.py: 36 layers, d_model 4096, 32 heads, kv
# 8, hd 128, bf16) served with the int8 KV cache beside its model-dtype
# cache on the same weights, B SERVE_BATCH, prompt SERVE_PROMPT,
# DENSE_GEN decode steps.  The int8 run's decode against the model-dtype
# run's within INT8_MODEL_RTOL of max |logits| (a decode that reads the
# cache without its scales reads ~1: the phase's control); the reduced
# config (float32, int8) on the card against the CPU (`card_cpu_phase`:
# CARD_CPU_RTOL, the decode at INT8_APART_DECODE_RTOL where an int8 value
# is a step apart).
INT8_ARCH, INT8_PHASE = "granite-8b", 39
INT8_MODEL_RTOL = 0.1


def int8_serve_phase(dev, seed: int, card: str) -> dict:
    """Phase 39: INT8_ARCH at its published widths served with the int8
    KV cache and with the model dtype on the same weights: cache bytes,
    peak memory, prefill tokens/s, decode ms a step and route counts of
    both; the int8 run's prefill and teacher-forced decode logits on the
    kernels against the int8 run on the plain attention (`ref.mha_ref`
    through the same dequantized cache) at SERVE_RTOL; the int8 decode
    against the model-dtype decode within INT8_MODEL_RTOL (control: the
    cache read without its scales must fail it); the reduced config card
    against CPU."""
    from unittest import mock
    import torch
    from repro_torch.kernels import flash_attention as kflash, ops, ref
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import LM, attention, init_params, serving

    t_phase = time.perf_counter()
    ph = INT8_PHASE
    base = serve.serve_config(INT8_ARCH)
    cfgs = {"int8": dataclasses.replace(base, kv_cache_dtype="int8"),
            "model": base}
    b, p, g = SERVE_BATCH, SERVE_PROMPT, DENSE_GEN
    model = init_params(base, seed=seed, device=dev)
    models = {k: LM(c, model.tree()) for k, c in cfgs.items()}
    del model
    prompts = torch.as_tensor(serve.make_prompts(base, b, p, seed),
                              device=dev)
    for m in models.values():                                   # warm up
        serve.generate(m, prompts[:, :128], 2)
    n_pre, n_dec = pass_launches(base), pass_launches(base, decode=True)
    want_routes = {"sm90": n_pre, "split": n_dec * (g - 1), "simt": 0}
    runs = {}
    for name, m in models.items():
        sync(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        run = serve.generate(m, prompts, g)
        counts, routes = ops.launch_counts(), kflash.route_counts()
        if counts["flash_attention"] != n_pre + n_dec * (g - 1) or any(
                n for k, n in counts.items() if k != "flash_attention") \
                or routes != want_routes:
            fail(f"phase {ph} {name} cache: launches {counts}, routes "
                 f"{routes}, want {want_routes}")
        peak = torch.cuda.max_memory_allocated(dev)
        runs[name] = dict(
            cache_bytes=tree_bytes(serving.init_cache(
                m.cfg, b, p + g, device="meta")), peak_bytes=peak,
            peak_over_weights=peak - held, prefill_s=run["prefill_s"],
            prefill_tps=b * p / run["prefill_s"],
            decode_ms=1e3 * run["decode_s"] / (g - 1), routes=routes,
            tokens=run["tokens"])
    r8, rm = runs["int8"], runs["model"]
    ratio = r8["cache_bytes"] / rm["cache_bytes"]
    log(f"phase {ph} serve {INT8_ARCH} B {b} prompt {p} gen {g}, int8 "
        f"cache against the model dtype ({base.dtype}) on the same weights: "
        + "; ".join(
            f"{n}: cache {r['cache_bytes'] / 1e9:.3f} GB, peak "
            f"{r['peak_bytes'] / 1e9:.2f} GB ({r['peak_over_weights'] / 1e9:.2f}"
            f" over the weights), prefill {r['prefill_s']:.3f} s "
            f"({r['prefill_tps']:.1f} tokens/s), decode "
            f"{r['decode_ms']:.2f} ms a step, routes {r['routes']}"
            for n, r in runs.items())
        + f"; cache ratio {ratio:.4f}; card {card}")

    prefill8 = make_prefill_step(cfgs["int8"], s_max=p + g)
    decode8 = make_decode_step(cfgs["int8"])
    m8 = models["int8"]
    ops.reset_launch_counts()
    with mock.patch.object(ops, "mha", ref.mha_ref):
        lg, cache = prefill8(m8, prompts)
        plain_logits, plain_toks = [lg], [lg[:, -1].argmax(-1)[:, None]]
        for i in range(g - 1):
            lg, cache = decode8(m8, cache, plain_toks[-1], p + i)
            plain_logits.append(lg)
            plain_toks.append(lg[:, -1].argmax(-1)[:, None])
    del cache
    if ops.launch_counts()["flash_attention"]:
        fail(f"phase {ph}: the plain run launched the kernel")

    def forced(name):
        """Prefill and the g - 1 decode steps teacher-forced by the plain
        run's tokens, on the kernels: (logits, the cache)."""
        m = models[name]
        decode = make_decode_step(m.cfg)
        lg, cache = make_prefill_step(m.cfg, s_max=p + g)(m, prompts)
        out = [lg]
        for i in range(g - 1):
            lg, cache = decode(m, cache, plain_toks[i], p + i)
            out.append(lg)
        return out, cache

    (k8, c8), (km, cm) = forced("int8"), forced("model")
    # device time of the last 3 decode steps again on each cache, the int8
    # cache's quantize and dequantize calls in profiler ranges
    prof = {}
    for name, cache in (("int8", c8), ("model", cm)):
        m = models[name]
        decode = make_decode_step(m.cfg)
        key = f"{INT8_ARCH} {name}"
        with profile_ranges(key):
            prof[name] = serve_profile(
                lambda: ([decode(m, cache, plain_toks[i], p + i)
                          for i in range(g - 4, g - 1)], sync(dev)),
                f"{name} cache, 3 decode steps", FLASH_PARTS, ph,
                PROFILE_RANGES.get(key))
    del c8, cm
    errs = [rel_err(a, w) for a, w in zip(k8, plain_logits)]
    finite = all(bool(torch.isfinite(x).all()) for x in k8 + plain_logits)
    if not finite or not max(errs) <= SERVE_RTOL:
        fail(f"phase {ph} int8: kernels against the plain attention, "
             f"prefill {errs[0]:.3g}, decode {max(errs[1:]):.3g} > "
             f"{SERVE_RTOL} of max |logits| (or not finite)")
    vs_model = [rel_err(a, w) for a, w in zip(k8[1:], km[1:])]
    with mock.patch.object(attention, "dequantize_kv",
                           lambda q, scale, dtype: q.to(dtype)):
        control = max(rel_err(a, w) for a, w in zip(forced("int8")[0][1:],
                                                    km[1:]))
    if not max(vs_model) <= INT8_MODEL_RTOL or not control > INT8_MODEL_RTOL:
        fail(f"phase {ph}: int8 decode against the model-dtype decode "
             f"{max(vs_model):.3g} (<= {INT8_MODEL_RTOL}?); the control "
             f"without the scales {control:.3g} (must exceed it)")
    agree = float((r8["tokens"] == torch.cat(plain_toks, 1)).float().mean())
    log(f"phase {ph} int8 serve: kernels against the plain attention on the "
        f"same dequantized cache, max |diff| / max |logits| prefill "
        f"{errs[0]:.3g}, decode (teacher-forced, {g - 1} steps) "
        f"{max(errs[1:]):.3g} <= {SERVE_RTOL}; the greedy run's tokens "
        f"equal the plain run's at {100 * agree:.1f}% of positions; int8 "
        f"decode against the model-dtype decode by step "
        f"{[round(x, 4) for x in vs_model]} <= {INT8_MODEL_RTOL} (prefill "
        f"logits {'bitwise equal' if torch.equal(k8[0], km[0]) else 'differ'}"
        f"); the control, the cache read without its scales, {control:.3g}"
        f": PASS")
    del models, m8, k8, km, plain_logits
    torch.cuda.empty_cache()
    card_cpu = card_cpu_phase(INT8_ARCH, seed, dev, ph, "int8")
    seconds = time.perf_counter() - t_phase
    log(f"phase {ph} int8 serving: {seconds:.1f} s: PASS")
    return dict(runs={n: {k: v for k, v in r.items() if k != "tokens"}
                      for n, r in runs.items()},
                decode_profile={n: {k: v for k, v in r.items() if k != "top"}
                                for n, r in prof.items()},
                cache_ratio=ratio, errs=errs, vs_model=vs_model,
                control=control, card_vs_cpu=card_cpu, seconds=seconds)


# ---------------------------------------------------------------- phase 40 --

TRAIN_LM_STEPS = 20
# The twins' plain gate: serve_batched's prefill and decode logits
# (teacher-forced by its own tokens) and train_lm's first step (its loss
# and every parameter leaf's gradient, from the twin's initial state and
# first batch) on the kernels against the same calls with `ops.mha` at
# `ref.mha_ref` (in training autograd's backward of it), each by max
# |diff| over max |value| (a gradient leaf's over its own max) within
# TWIN_RTOL, float32 with TF32 off.  The control, the plain attention
# with every causal call's window cut to TWIN_CONTROL_WINDOW keys, must
# fail it.  These are the only calls at the twins' shapes: serve_batched
# prefills 24 tokens on `split` (B 4, H 8, Hkv 4, hd 256), train_lm
# trains at B 8, S 256, H 12, Hkv 4 (groups of 3), hd 64 on `simt`.
TWIN_RTOL = SERVE_F32_RTOL
TWIN_CONTROL_WINDOW = 8


def twin_serve_logits(sb: dict, mha) -> list:
    """serve_batched's prefill and its decode steps teacher-forced by the
    run's own tokens, with `ops.mha` at `mha`: each call's logits."""
    from unittest import mock
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_batched
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    model, n = sb["model"], serve_batched.PROMPT_LEN
    toks = sb["tokens"].to(sb["prompts"].device)
    decode = make_decode_step(model.cfg)
    with mock.patch.object(ops, "mha", mha):
        lg, cache = make_prefill_step(model.cfg, s_max=n + serve_batched.GEN)(
            model, sb["prompts"])
        out = [lg]
        for i in range(serve_batched.GEN - 1):
            lg, cache = decode(model, cache, toks[:, i:i + 1], n + i)
            out.append(lg)
    return out


def twin_train_first_step(dev):
    """train_lm's default config, its initial state (seed 0) and first
    batch on `dev`, and the head's read p of step 0, as its train step
    draws it: (model, batch, cfg, p) for `train_grads`."""
    from repro_torch.core import mtl_head
    from repro_torch.data import ShardedBatcher, synthetic_lm_batches
    from repro_torch.launch import train_lm
    from repro_torch.launch.steps import (default_optimizer,
                                          init_train_state, train_keys)
    cfg = train_lm.build_config(small=False)
    opt = default_optimizer(cfg, lr=3e-4, total_steps=TRAIN_LM_STEPS)
    state = init_train_state(cfg, opt, seed=0, device=dev)
    batch = next(ShardedBatcher(synthetic_lm_batches(
        cfg.vocab_size, train_lm.SEQ, train_lm.BATCH, cfg.mtl.num_tasks,
        seed=train_lm.DATA_SEED), device=dev))
    v_hat, _ = mtl_head.stale_read(state.mtl, cfg.mtl, train_keys(0)[0])
    p = mtl_head.get_regularizer(cfg.mtl.reg_name).prox(
        v_hat, mtl_head.prox_threshold(cfg.mtl))
    return state.params, batch, cfg, p


def lm_twins_phase(dev, card: str) -> dict:
    """Phase 40: the twins of examples/serve_batched.py (reduced gemma2-2b,
    float32) and examples/train_lm.py (granite-100m, float32,
    TRAIN_LM_STEPS steps, its record written under build/ and removed) on
    the card, each with the flash launches its passes call for, and each
    held to the plain attention at its own shapes (TWIN_RTOL, with a
    control that must fail)."""
    from unittest import mock
    import torch
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve_batched, train_lm

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"        # the CPU launches no kernel
    control = mha_ref_control(window=TWIN_CONTROL_WINDOW)
    ops.reset_launch_counts()
    sb = serve_batched.main(["--device", dev.type])
    counts = ops.launch_counts()
    serve_routes = kflash.route_counts()
    n = pass_launches(sb["model"].cfg)
    want = n * serve_batched.GEN
    logits = torch.cat([x.float() for x in sb["logits"]], 1)
    if on_card and (counts["flash_attention"] != want or any(
            c for k, c in counts.items() if k != "flash_attention")) \
            or not bool(torch.isfinite(logits).all()) \
            or tuple(sb["tokens"].shape) != (serve_batched.BATCH,
                                              serve_batched.GEN):
        fail(f"phase 40 serve_batched: launches {counts}, want "
             f"flash_attention {want}; tokens {tuple(sb['tokens'].shape)}; "
             "logits finite?")
    with torch.inference_mode():
        plain = twin_serve_logits(sb, ref.mha_ref)
        cut = twin_serve_logits(sb, control)
    if ops.launch_counts() != counts:
        fail(f"phase 40 serve_batched: the plain runs launched a kernel: "
             f"{ops.launch_counts()} after {counts}")
    s_errs = [rel_err(a, w) for a, w in zip(sb["logits"], plain)]
    s_control = max(rel_err(a, w) for a, w in zip(sb["logits"], cut))
    if not max(s_errs) <= TWIN_RTOL or not s_control > TWIN_RTOL:
        fail(f"phase 40 serve_batched against the plain attention: prefill "
             f"{s_errs[0]:.3g}, decode {max(s_errs[1:]):.3g} (<= "
             f"{TWIN_RTOL}?); the control {s_control:.3g} (must exceed it)")
    log(f"phase 40 serve_batched twin on the card: prefill "
        f"{sb['prefill_s']:.3f} s, {serve_batched.GEN} tokens x "
        f"{serve_batched.BATCH} in {sb['decode_s']:.3f} s; flash launches "
        f"{want} (routes {serve_routes}); its logits against the plain "
        f"attention's (teacher-forced by its tokens) prefill "
        f"{s_errs[0]:.3g}, decode {max(s_errs[1:]):.3g} <= {TWIN_RTOL} of "
        f"max |logits|, the control (window {TWIN_CONTROL_WINDOW}) "
        f"{s_control:.3g} [{card}]: PASS")
    del sb, plain, cut

    ckpt = ROOT / "build" / "train_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ops.reset_launch_counts()
    tl = train_lm.main(["--steps", str(TRAIN_LM_STEPS), "--ckpt",
                        str(ckpt), "--device", dev.type])
    counts = ops.launch_counts()
    train_routes = {"forward": kflash.route_counts(),
                    "backward": kbwd.route_counts()}
    fwd, bwd = train_launches(train_lm.build_config(small=False))
    want = {"flash_attention": fwd * TRAIN_LM_STEPS,
            "flash_attention_bwd": bwd * TRAIN_LM_STEPS}
    got = {k: c for k, c in counts.items() if c}
    losses = [r["loss"] for r in tl["log"]]
    if on_card and got != want or not np.isfinite(losses).all() \
            or not np.isfinite(tl["singular_values"]).all() \
            or not Path(tl["ckpt"]).is_file() or tl["step"] != TRAIN_LM_STEPS:
        fail(f"phase 40 train_lm: launches {got}, want {want}; losses "
             f"{losses}; singular values {tl['singular_values']}; record "
             f"{tl['ckpt']}")
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"phase 40 train_lm twin on the card: granite-100m "
        f"({tl['n_params'] / 1e6:.1f}M), {TRAIN_LM_STEPS} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} ({tl['log'][-1]['seconds']:.1f}"
        f" s), launches {got} (routes {train_routes}), the record written "
        f"and removed, singular values finite [{card}]")

    model, batch, cfg, p = twin_train_first_step(dev)
    ops.reset_launch_counts()
    loss_k, grads_k = train_grads(model, batch, cfg, p)
    one = {k: c for k, c in ops.launch_counts().items() if c}
    if on_card and one != {"flash_attention": fwd,
                           "flash_attention_bwd": bwd}:
        fail(f"phase 40 train_lm's first step: launches {one}, want "
             f"{fwd} forward and {bwd} backward")
    runs = {}
    for name, mha in (("plain", ref.mha_ref), ("control", control)):
        with mock.patch.object(ops, "mha", mha):
            runs[name] = train_grads(model, batch, cfg, p)
    if {k: c for k, c in ops.launch_counts().items() if c} != one:
        fail("phase 40 train_lm: the plain runs launched a kernel")
    reads = {}
    for name, (loss, grads) in runs.items():
        errs = {k: e[0] for k, e in leaf_errs(grads_k, grads).items()}
        worst = max(errs, key=errs.get)
        reads[name] = dict(loss=abs(loss_k - loss) / abs(loss),
                           worst_leaf=worst, grad=errs[worst],
                           median=float(np.median(list(errs.values()))))
    zero = [k for k, g in grads_k.items() if not bool(g.abs().max() > 0)]
    pl, ct = reads["plain"], reads["control"]
    if not max(pl["loss"], pl["grad"]) <= TWIN_RTOL \
            or not ct["grad"] > TWIN_RTOL or zero \
            or not math.isfinite(loss_k):
        fail(f"phase 40 train_lm's first step against the plain attention: "
             f"{pl} (<= {TWIN_RTOL}?); the control {ct} (its gradient must "
             f"exceed it); zero gradients {zero}")
    del model, batch, grads_k, runs
    seconds = time.perf_counter() - t0
    log(f"phase 40 train_lm's first step (B {train_lm.BATCH}, S "
        f"{train_lm.SEQ}, H {cfg.num_heads}, Hkv {cfg.num_kv_heads}, hd "
        f"{cfg.head_dim}) on the kernels ({fwd} forward, {bwd} backward "
        f"launches) against the plain attention under autograd: loss "
        f"{pl['loss']:.3g}, gradient worst leaf {pl['worst_leaf']} "
        f"{pl['grad']:.3g} (median {pl['median']:.3g}) <= {TWIN_RTOL} of "
        f"max |grad|; the control (window {TWIN_CONTROL_WINDOW}) worst leaf "
        f"{ct['grad']:.3g}, loss {ct['loss']:.3g}; every leaf's gradient "
        f"non-zero; the phase {seconds:.1f} s [{card}]: PASS")
    return dict(serve_routes=serve_routes, train_routes=train_routes,
                serve_errs=s_errs, serve_control=s_control,
                train_first_step=reads, seconds=seconds)


# ---------------------------------------------------------------- phase 41 --

def dryrun_phase(dev) -> dict:
    """Phase 41: `launch/dryrun.py --all`, with and without --kv-int8, on
    the meta device (rows under build/dryrun/): the ok and skip rows and
    granite-8b's decode_32k cache bytes under both settings; the card's
    memory untouched."""
    import torch
    from repro_torch.launch import dryrun

    def held():
        return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0

    t0 = time.perf_counter()
    out = ROOT / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    before = held()
    res = {}
    for kv in ("model", "int8"):
        rows = dryrun.main(["--all", "--out", str(out / f"{kv}.jsonl")]
                           + (["--kv-int8"] if kv == "int8" else []))
        ok = sum(r["status"] == "ok" for r in rows)
        granite = next(r for r in rows if (r["arch"], r["shape"])
                       == ("granite-8b", "decode_32k"))
        res[kv] = dict(ok=ok, skip=len(rows) - ok,
                       granite_decode_32k_cache_bytes=granite["cache_bytes"])
    ratio = (res["int8"]["granite_decode_32k_cache_bytes"]
             / res["model"]["granite_decode_32k_cache_bytes"])
    if any((r["ok"], r["skip"]) != (33, 7) for r in res.values()) \
            or ratio != (128 + 4) / 256 \
            or held() != before:
        fail(f"phase 41 dry run: {res}, int8/model cache ratio {ratio}, "
             "want 33 ok and 7 skip each and (128 + 4) / 256, the card's "
             "memory untouched")
    shutil.rmtree(out, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"phase 41 dry run on the meta device, --all and --all --kv-int8: "
        f"{res['model']['ok']} ok + {res['model']['skip']} skip rows each; "
        f"granite-8b decode_32k cache "
        f"{res['model']['granite_decode_32k_cache_bytes'] / 1e9:.2f} GB, "
        f"int8 {res['int8']['granite_decode_32k_cache_bytes'] / 1e9:.2f} GB "
        f"(ratio {ratio:.4f}); {seconds:.1f} s: PASS")
    return dict(res, seconds=seconds)


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
        from repro_torch.launch.mesh import World
    except ImportError as e:
        fail(f"the port (src/repro_torch) is not next to chip_smoke.py: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())

    # the host's disk and memory, before any phase
    host_resources()
    t_smoke = time.perf_counter()

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
    mark(t_smoke, "1-3")

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

    mark(t_smoke, "4-9")

    # phases 15-19: the dense engine and the l2,1 formulation
    dense_counts = l21_phases(problem, problem_cpu, v0, key, offs, dev)
    del problem_cpu
    torch.cuda.empty_cache()
    mark(t_smoke, "15-19")

    # phases 10-11: gemma2-2b serving at full width; 13-14: rwkv6-3b
    sv = serve_phase(dev, args.seed, card, "gemma2-2b")
    torch.cuda.empty_cache()
    mark(t_smoke, "10-11")
    rw = serve_phase(dev, args.seed, card, "rwkv6-3b")
    torch.cuda.empty_cache()
    mark(t_smoke, "13-14")
    # phases 26-28: granite-8b, nemotron-4-15b, gemma3-12b at full width
    dense = {}
    for arch in DENSE_ARCHS:
        dense[arch] = serve_phase(dev, args.seed, card, arch)
        torch.cuda.empty_cache()
    mark(t_smoke, "26-28")
    # phases 29-30: zamba2-7b and llama-3.2-vision-11b at full width
    hybrid = {}
    for arch in HYBRID_ARCHS:
        t_arch = time.perf_counter()
        hybrid[arch] = serve_phase(dev, args.seed, card, arch)
        hybrid[arch]["seconds"] = time.perf_counter() - t_arch
        torch.cuda.empty_cache()
    mark(t_smoke, "29-30")
    # phases 35-36: dbrx-132b and deepseek-v3-671b at their published
    # widths, SERVE_PERIODS periods
    moe_served = {}
    for arch in MOE_ARCHS:
        t_arch = time.perf_counter()
        moe_served[arch] = serve_phase(dev, args.seed, card, arch)
        moe_served[arch]["seconds"] = time.perf_counter() - t_arch
        torch.cuda.empty_cache()
    mark(t_smoke, "35-36")

    # phases 21-22 run their ranks' sessions in two worlds of SHARD_RANKS
    # ranks on this card, the saves in the first and the restores in the
    # second, started now: their spawns, imports, card contexts and
    # rendezvous pass during phase 20's set-up (four spawns took 16-25 s
    # each of the smoke on an H100 host, outside the ranks' sessions)
    worlds = [World(SHARD_RANKS, device=dev.type,
                    collective_timeout=SHARD_COLLECTIVE_TIMEOUT_S,
                    workdir=str(ROOT / "build")) for _ in range(2)]

    # phase 20: the learn-while-serve AMTLServer at the engine cells' width
    amtl_serve = amtl_serve_phase(dev, args.seed, card)
    torch.cuda.empty_cache()
    mark(t_smoke, "20")

    # phase 21: the task-sharded engine, one rank and SHARD_RANKS ranks
    sharded = sharded_phase(dev, args.seed, card, problem, v0, offs, key, b,
                            worlds)
    torch.cuda.empty_cache()
    mark(t_smoke, "21")

    # phase 22: the server on LOCK_RANKS ranks stepping in lockstep
    lockstep = lockstep_serve_phase(dev, args.seed, card, worlds)
    for world in worlds:
        world.close()
    torch.cuda.empty_cache()
    mark(t_smoke, "22")

    # phase 23: the twins of the quickstart and hospitals examples
    twins = twins_phase(dev, card)
    torch.cuda.empty_cache()
    mark(t_smoke, "23")

    # phase 24: gemma2-2b training at full width with the AMTL head; 25:
    # rwkv6-3b
    train = train_phase(dev, args.seed, card, "gemma2-2b")
    mark(t_smoke, "24")
    rwkv_train = train_phase(dev, args.seed, card, "rwkv6-3b")
    mark(t_smoke, "25")
    # phase 31: hubert-xlarge's encoder forward at full width; 32: its
    # training
    encoder = encoder_phase(dev, args.seed, card)
    torch.cuda.empty_cache()
    mark(t_smoke, "31")
    hubert_train = train_phase(dev, args.seed, card, ENCODER_ARCH)
    mark(t_smoke, "32")
    # phases 33-34: zamba2-7b and llama-3.2-vision-11b training at their
    # published widths, TRAIN_PERIODS periods
    hybrid_train = {}
    for arch in HYBRID_ARCHS:
        hybrid_train[arch] = train_phase(dev, args.seed, card, arch)
        mark(t_smoke, str(TRAINED[arch]["phase"]))
    # phases 37-38: dbrx-132b and deepseek-v3-671b training at their
    # published widths, TRAIN_PERIODS periods, under Adafactor
    moe_train = {}
    for arch in MOE_ARCHS:
        moe_train[arch] = train_phase(dev, args.seed, card, arch)
        mark(t_smoke, str(TRAINED[arch]["phase"]))
    # phase 39: granite-8b served with the int8 KV cache; 40: the twins of
    # examples/serve_batched.py and train_lm.py; 41: the meta-device dry run
    int8_serve = int8_serve_phase(dev, args.seed, card)
    torch.cuda.empty_cache()
    mark(t_smoke, "39")
    lm_twins = lm_twins_phase(dev, card)
    torch.cuda.empty_cache()
    mark(t_smoke, "40")
    dry = dryrun_phase(dev)
    mark(t_smoke, "41")

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
        if lockstep["launches"]["1"].get(name):
            kernels[-1]["lockstep_serve_launches"] = {
                n: c[name] for n, c in lockstep["launches"].items()}
        example = {n: c[name] for n, c in twins["launches"].items()
                   if c.get(name)}
        if example:
            kernels[-1]["example_launches"] = example
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
    mark(t_smoke, "12 (the kernels' main shapes)")
    flash = kernels[[k["name"] for k in kernels].index("flash_attention")]
    flash["routes"] = flash_times(info["flash_attention"]["served"], dev)
    flash["library_ms"] = flash["routes"]["sm90"]["library_ms"]
    flash["train_launches"] = train["launches"]["flash_attention"]
    flash["dense_serve_launches"] = {
        a: dict(r["routes"], float32_prefill_simt=r["f32_launches"])
        for a, r in dense.items()}
    flash["hybrid_serve_launches"] = {
        a: dict(r["routes"], float32_prefill_simt=r["f32_launches"])
        for a, r in hybrid.items()}
    flash["moe_serve_launches"] = {
        a: dict(r["routes"], float32_prefill_simt=r["f32_launches"],
                layers=r["layers"]) for a, r in moe_served.items()}
    mark(t_smoke, "12 (flash routes)")
    flash["hybrid_shapes"] = flash_hybrid_times(dev)
    mark(t_smoke, "12 (flash shapes)")
    flash["hubert_launches"] = {
        "encoder": encoder["routes"],
        "train": hubert_train["launches"]["fwd_routes"]}
    flash["hybrid_train_launches"] = {
        a: r["launches"]["fwd_routes"] for a, r in hybrid_train.items()}
    flash["moe_train_launches"] = {
        a: r["launches"]["fwd_routes"] for a, r in moe_train.items()}
    flash["int8_serve_launches"] = {
        n: r["routes"] for n, r in int8_serve["runs"].items()}
    flash["lm_example_launches"] = {
        "serve_batched": lm_twins["serve_routes"],
        "train_lm": lm_twins["train_routes"]["forward"]}
    kernels.append(flash_bwd_times(
        info["flash_attention_bwd"], train["launches"]["bwd_routes"], dev))
    del info["flash_attention_bwd"]
    kernels[-1]["lm_example_launches"] = {
        "train_lm": lm_twins["train_routes"]["backward"]}
    mark(t_smoke, "12 (flash backward)")
    kernels[-1]["shapes"] = flash_bwd_shape_times(dev, {
        a: r["launches"]["bwd_routes"] for a, r in
        (("hubert-xlarge", hubert_train), *hybrid_train.items(),
         *moe_train.items())})
    mark(t_smoke, "12 (flash backward shapes)")
    wkv = kernels[[k["name"] for k in kernels].index("rwkv6_scan")]
    wkv["routes"] = rwkv_times(info["rwkv6_scan"], rw["routes"])
    wkv["train_launches"] = rwkv_train["launches"]["fwd_routes"]
    kernels.append(wkv_bwd_times(info["rwkv6_bwd"],
                                 rwkv_train["launches"]["bwd_routes"], dev))
    del info["rwkv6_bwd"]
    mark(t_smoke, "12 (WKV)")
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

    log("training " + json.dumps({k: v for k, v in train.items()
                                  if k != "rows"}))
    log("training rwkv6-3b " + json.dumps({k: v for k, v in rwkv_train.items()
                                           if k != "rows"}))
    log("encoder hubert-xlarge " + json.dumps(encoder))
    log("training hubert-xlarge " + json.dumps(
        {k: v for k, v in hubert_train.items() if k != "rows"}))
    for arch, r in (*hybrid_train.items(), *moe_train.items()):
        log(f"training {arch} " + json.dumps(
            {k: v for k, v in r.items() if k != "rows"}))
    log("dense serves " + json.dumps({a: {k: r[k] for k in (
        "prefill_tps", "decode_tps", "errs", "e32", "tol", "f32_layers")}
        for a, r in dense.items()}))
    log("hybrid serves " + json.dumps({a: {k: r[k] for k in (
        "prefill_tps", "decode_tps", "prefill_s", "decode_s", "errs", "e32",
        "tol", "f32_layers", "f32_launches", "routes", "prefill_profile",
        "card_vs_cpu", "seconds")} for a, r in hybrid.items()}))
    log("moe serves " + json.dumps({a: {k: r[k] for k in (
        "layers", "params_m", "prefill_tps", "decode_tps", "prefill_s",
        "decode_s", "errs", "e32", "tol", "f32_layers", "f32_launches",
        "routes", "prefill_profile", "decode_profile", "peak_bytes",
        "card_vs_cpu", "seconds")} for a, r in moe_served.items()}))
    log("int8 serve " + json.dumps(int8_serve))
    log("dry run " + json.dumps(dry))
    log(f"smoke: {time.perf_counter() - t_smoke:.1f} s from phase 1 "
        f"[{card}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
