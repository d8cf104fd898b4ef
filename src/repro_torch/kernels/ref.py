"""Plain PyTorch versions of the kernels on the engine path.

Each function is the semantic ground truth for its CUDA kernel and the
port of the function of the same name in the reference package's
`kernels/ref.py`.  They run on any device; `ops` sends CPU tensors here.
The minibatch cutoffs (`sample_cutoff`, `sample_cutoff_masked`,
`sample_scalars`) are host functions in numpy uint32: the engines plan
them on the host, before any device work.

The KM update is written as the two fused multiply-adds that XLA's CPU
backend emits for `v + eta_k*(p - eta*g - v)`:

    fma(eta_k, fma(-eta, g, p) - v, v)

so that the port reproduces the reference's float32 bits.  PyTorch has no
fma, so `_fma32` forms it exactly: the product of two float32 values is
exact in float64, the float64 sum is rounded to odd, and rounding that to
float32 then equals one correctly rounded fma.  The CUDA kernels write the
same two `__fmaf_rn` calls.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import _build, flash_attention

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF


def to_f32(x) -> float:
    """A Python number rounded to the nearest float32 value."""
    return float(np.float32(float(x)))


def _fma32(a: Tensor | float, b: Tensor, c: Tensor) -> Tensor:
    """float32 fma(a, b, c) = round(a*b + c) with a single rounding.

    All operands are float32 values.  a*b is exact in float64; the sum is
    rounded to odd (TwoSum error, then a one-ulp step towards it when the
    float64 result is even), which makes the final float32 rounding the
    correct one.
    """
    a64 = torch.as_tensor(a, dtype=torch.float32).to(torch.float64)
    s = a64 * b.to(torch.float64)
    c64 = c.to(torch.float64)
    r = s + c64
    bb = r - s
    err = (s - (r - bb)) + (c64 - bb)
    even = (r.view(torch.int64) & 1) == 0
    step = torch.where(err > 0, torch.full_like(r, math.inf),
                       torch.full_like(r, -math.inf))
    r = torch.where((err != 0) & even, torch.nextafter(r, step), r)
    return r.to(torch.float32)


def km_update_ref(v: Tensor, p: Tensor, g: Tensor, eta: float,
                  eta_k: float) -> Tensor:
    """Fused AMTL update (paper Eq. III.4): v + eta_k*(p - eta*g - v)."""
    a = _fma32(-to_f32(eta), g.to(torch.float32), p.to(torch.float32))
    return _fma32(to_f32(eta_k), a - v, v.to(torch.float32)).to(v.dtype)


def amtl_event_ref(v_t: Tensor, p_t: Tensor, g_t: Tensor, eta: float,
                   eta_k: float) -> tuple[Tensor, Tensor]:
    """Fused delta-ring column event: (Eq. III.4 update, undo-log entry).

    The second output is a copy of the exact pre-write bits of v_t.
    """
    return km_update_ref(v_t, p_t, g_t, eta, eta_k), v_t.clone()


def amtl_event_inplace_ref(v: Tensor, t, p_t: Tensor, g_t: Tensor,
                           eta: float, eta_k: float, ring: Tensor,
                           slot) -> None:
    """The delta engine's column event on its own state, in place, as the
    kernel does it: column t of v (d, T) takes `amtl_event_ref`'s update
    and ring[slot] (ring (depth, d)) its undo entry, the pre-write bits.
    The arguments are checked as the kernel's wrapper checks them: t and
    slot must lie in [0, T) and [0, depth)."""
    t, slot = _build.amtl_event_inplace_args(v, t, p_t, g_t, ring, slot)
    v_new, old = amtl_event_ref(v[:, t], p_t, g_t, eta, eta_k)
    ring[slot] = old
    v[:, t] = v_new


def km_update_slot_ref(ring: Tensor, src, dst, t, p_t: Tensor, g_t: Tensor,
                       eta: float, eta_k: float) -> None:
    """The dense engine's event on its (depth, d, T) ring, in place, as
    the kernel does it: ring[dst] = ring[src] with column t replaced by
    `km_update_ref` of ring[src]'s column t (src == dst: that column
    alone).  Arguments checked as the kernel's wrapper checks them."""
    src, dst, t = _build.km_update_slot_args(ring, src, dst, t, p_t, g_t)
    col = km_update_ref(ring[src, :, t], p_t, g_t, eta, eta_k)
    if dst != src:
        ring[dst] = ring[src]
    ring[dst, :, t] = col


def last_occurrence_mask(tasks: Tensor) -> Tensor:
    """(B,) bool: event i is the LAST in-batch occurrence of its task."""
    idx = torch.arange(tasks.shape[0], device=tasks.device)
    later_dup = ((tasks[None, :] == tasks[:, None])
                 & (idx[None, :] > idx[:, None]))
    return ~torch.any(later_dup, dim=1)


def shard_local_tasks(tasks, t_offset: int, n_local: int):
    """Map global task ids onto a rank's local column block: (local ids,
    owned), numpy or tensors as `tasks` is.

    An owned event gets its column in [0, n_local); an event of another
    rank gets the sentinel `n_local`, one past the block's last column,
    which `amtl_event_batch` drops (it never writes the block).
    """
    local = tasks - int(t_offset)
    owned = (local >= 0) & (local < n_local)
    if isinstance(tasks, Tensor):
        sentinel = torch.full_like(local, n_local)
        return torch.where(owned, local, sentinel).to(torch.int32), owned
    return np.where(owned, local, n_local).astype(np.int32), owned


def amtl_event_batch_ref(v: Tensor, p_cols: Tensor, g_cols: Tensor,
                         tasks: Tensor, eta: float,
                         eta_ks: Tensor) -> tuple[Tensor, Tensor]:
    """Batched fused column events, serialized in event order, IN PLACE.

    v: (d, T) iterate, updated in place and returned; p_cols/g_cols: (d, B);
    tasks: (B,) ids; eta_ks: (B,).  Returns (v, undo (B, d)).

    Event i reads its task's column as left by the earlier events of the
    batch, records that column as its undo entry, and writes its update
    back.  An id >= T is dropped (the sharded engine's sentinel): it never
    writes v, and its undo entry is what the reference's clamped gather
    gives, the pre-batch column T-1, or the output of the latest earlier
    event with the same id.
    """
    d, num_t = v.shape
    ids = [int(t) for t in tasks.tolist()]
    if any(t < 0 for t in ids):
        raise ValueError(f"task ids must be >= 0, got {ids}")
    ks = eta_ks.tolist()
    last_col = v[:, num_t - 1].clone()
    dropped: dict[int, Tensor] = {}
    undo = torch.empty((len(ids), d), dtype=v.dtype, device=v.device)
    for i, t in enumerate(ids):
        cur = v[:, t] if t < num_t else dropped.get(t, last_col)
        undo[i] = cur
        out = km_update_ref(undo[i], p_cols[:, i], g_cols[:, i], eta, ks[i])
        if t < num_t:
            v[:, t] = out
        else:
            dropped[t] = out
    return v, undo


def svt_reconstruct_ref(qu: Tensor, s: Tensor, vt: Tensor) -> Tensor:
    """Thresholded low-rank apply: (QU * sigma) @ V^T, in float32."""
    qu32 = qu.to(torch.float32)
    return ((qu32 * s.to(torch.float32)[None, :])
            @ vt.to(torch.float32)).to(qu.dtype)


def l21_prox_ref(w: Tensor, t: float) -> Tensor:
    """Row-group soft threshold: w^i * max(0, 1 - t/max(||w^i||_2, 1e-12)),
    in float32, cast back to w's dtype."""
    w32 = w.to(torch.float32)
    norms = torch.linalg.vector_norm(w32, dim=-1, keepdim=True)
    scale = torch.clamp(1.0 - to_f32(t) / torch.clamp(norms, min=1e-12),
                        min=0.0)
    return (w32 * scale).to(w.dtype)


# ------------------------------------------------ counter-based normals ---
#
# uint32 arithmetic in int64 tensors: every product is split so that it
# stays below 2**63, and every result is masked back to 32 bits.

def _mul32(x: Tensor, c: int) -> Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def counter_hash(seed: int, ctr: Tensor) -> Tensor:
    """uint32 lowbias32 hash of (seed, counter), as int64 in [0, 2**32)."""
    x = _mul32(ctr.to(torch.int64) & _M32, 0x9E3779B9) ^ (int(seed) & _M32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def gauss_from_counters(seed: int, ctr: Tensor) -> Tensor:
    """float32 standard normals from uint32 counters (Box-Muller)."""
    c2 = (ctr.to(torch.int64) * 2) & _M32
    u1 = counter_hash(seed, c2)
    u2 = counter_hash(seed, (c2 + 1) & _M32)
    f1 = ((u1 >> 8).to(torch.float32) + 1.0) * (2.0 ** -24)
    f2 = (u2 >> 8).to(torch.float32) * (2.0 ** -24)
    two_pi = torch.tensor(2.0 * 3.141592653589793, dtype=torch.float32)
    return torch.sqrt(-2.0 * torch.log(f1)) * torch.cos(two_pi * f2)


def gauss_omega_ref(rows: int, p: int, seed: int, row_offset: int = 0,
                    device: torch.device | str = "cpu") -> Tensor:
    """(rows, p) float32 block of the counter-generated sketch Omega.

    Entry (r, c) is gauss_from_counters(seed, (row_offset + r) * p + c).
    """
    r_idx = (row_offset + torch.arange(rows, dtype=torch.int64,
                                       device=device))[:, None]
    c_idx = torch.arange(p, dtype=torch.int64, device=device)[None, :]
    return gauss_from_counters(seed, (r_idx * p + c_idx) & _M32)


def gauss_sketch_ref(w: Tensor, seed: int, row_offset: int, p: int) -> Tensor:
    """(d, p) float32 sketch W @ Omega with Omega materialized."""
    omega = gauss_omega_ref(w.shape[1], p, seed, row_offset, w.device)
    return w.to(torch.float32) @ omega


# ------------------------------------------------------ gradient kernels ---

def lstsq_grad_ref(x: Tensor, w: Tensor, y: Tensor) -> Tensor:
    """Fused least-squares gradient 2 X^T (X w - y) (paper forward step)."""
    x32, w32, y32 = (a.to(torch.float32) for a in (x, w, y))
    return (2.0 * (x32.T @ (x32 @ w32 - y32))).to(w.dtype)


def lstsq_grad_masked_ref(x: Tensor, w: Tensor, y: Tensor, n_t) -> Tensor:
    """Ragged least-squares gradient: rows >= n_t masked out of the
    residual (never out of X).  With n_t == n the all-true `where` passes
    the residual's bits through, so this is `lstsq_grad_ref` bitwise."""
    x32, w32, y32 = (a.to(torch.float32) for a in (x, w, y))
    rows = torch.arange(x.shape[0], device=x.device)
    r = torch.where(rows < n_t, x32 @ w32 - y32, 0.0)
    return (2.0 * (x32.T @ r)).to(w.dtype)


def lstsq_grad_task_ref(xs: Tensor, ys: Tensor, t: int, w: Tensor,
                        row_counts: Tensor | None = None) -> Tensor:
    """The full gradient of task t (picked by `task_index`) at w on the
    buffers xs (T, n, d), ys (T, n): `lstsq_grad_masked_ref` with the
    task's row count, or `lstsq_grad_ref` when row_counts is None."""
    t = task_index(int(t), xs.shape[0])
    if row_counts is None:
        return lstsq_grad_ref(xs[t], w, ys[t])
    return lstsq_grad_masked_ref(xs[t], w, ys[t], row_counts[t])


def lstsq_grad_batch_ref(xs: Tensor, ys: Tensor, tasks: Tensor,
                         w_rows: Tensor,
                         row_counts: Tensor | None = None) -> Tensor:
    """(B, d) full gradients of B events: row e is `lstsq_grad_task_ref`
    of task tasks[e] at w_rows[e], each with the single event's bits."""
    return torch.stack([lstsq_grad_task_ref(xs, ys, t, w_rows[e], row_counts)
                        for e, t in enumerate(tasks.tolist())])


# ------------------------------------------------ counter-based sampling ---
#
# The minibatch of an event is the exactly-bsz rows whose counter_hash(seed,
# row) ranks smallest, ties broken by row index (a stable argsort of the
# hashes IS the (hash, row) order).  The cut is summarized by the bsz-th
# smallest pair (cut_h, cut_i); with the event's seed and valid-row count
# n_t it forms the (seed, cut_h, cut_i, n_t) uint32 scalar block from which
# every row's keep bit is a local predicate (`keep_bits_ref`, and
# `keep_bit` in csrc/counter_hash.cuh).

_SAT = 0xFFFFFFFF
_CHUNK = 1024            # events hashed at once by `sample_scalars`


def counter_hash_np(seed, ctr) -> np.ndarray:
    """`counter_hash` in numpy uint32 (wrapping) arithmetic, broadcast over
    `seed` and `ctr`."""
    x = (np.asarray(ctr, np.uint32) * np.uint32(0x9E3779B9)) \
        ^ np.asarray(seed, np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def sample_scalars(n: int, batch_size: int, seeds,
                   n_ts=None) -> np.ndarray:
    """(N, 4) uint32 scalar blocks (seed, cut_h, cut_i, n_t) of N events.

    The port of the reference's `_scalars`: the cutoff over the valid rows
    (`sample_cutoff_masked`), or over all n rows when `n_ts` is None (then
    n_t = n, which gives `sample_cutoff`'s pair).  Events with
    batch_size >= n_t saturate to (0xFFFFFFFF, n - 1).

    For a fixed seed the hash is a bijection of the row (odd multiplies,
    xors and xorshifts), so no two rows tie and the (hash, row) order of
    the reference's stable argsort is the hash order: the cut is the
    bsz-th smallest of the keys hash + 2^32 * (row >= n_t), found by a
    partial sort.
    """
    seeds = np.asarray(seeds, np.uint32).reshape(-1)
    count = seeds.shape[0]
    n_ts = (np.full((count,), n, np.int64) if n_ts is None
            else np.asarray(n_ts, np.int64).reshape(-1))
    out = np.empty((count, 4), np.uint32)
    out[:, 0] = seeds
    out[:, 1] = _SAT
    out[:, 2] = max(n - 1, 0)
    out[:, 3] = n_ts
    todo = np.flatnonzero(batch_size < n_ts)
    rows = np.arange(n, dtype=np.uint32)
    for lo in range(0, todo.shape[0], _CHUNK):
        ev = todo[lo:lo + _CHUNK]
        keys = counter_hash_np(seeds[ev, None], rows[None, :]).astype(
            np.uint64)
        keys |= (rows[None, :] >= n_ts[ev, None]).astype(np.uint64) << 32
        kth = np.partition(keys, batch_size - 1, axis=1)[:, batch_size - 1]
        out[ev, 1] = kth & _SAT
        out[ev, 2] = np.argmax(keys == kth[:, None], axis=1)
    return out


def sample_cutoff(n: int, batch_size: int, seed) -> tuple[int, int]:
    """(cut_h, cut_i): the bsz-th smallest (hash, row) pair of all n rows,
    bsz = min(batch_size, n); saturated when batch_size >= n."""
    row = sample_scalars(n, batch_size, [seed])[0]
    return int(row[1]), int(row[2])


def sample_cutoff_masked(n: int, batch_size: int, seed,
                         n_t: int) -> tuple[int, int]:
    """(cut_h, cut_i) among the valid rows < n_t of an n-row buffer,
    bsz = min(batch_size, n_t); saturated when batch_size >= n_t."""
    row = sample_scalars(n, batch_size, [seed], [n_t])[0]
    return int(row[1]), int(row[2])


def keep_bits_ref(n: int, scalars, device="cpu") -> Tensor:
    """(n,) bool keep bits of one scalar block (seed, cut_h, cut_i, n_t):
    h_i < cut_h or (h_i == cut_h and i <= cut_i), and i < n_t."""
    seed, cut_h, cut_i, n_t = (int(s) for s in scalars)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    h = counter_hash(seed, idx)
    keep = (h < cut_h) | ((h == cut_h) & (idx <= cut_i))
    return keep & (idx < n_t)


def sample_rows_ref(x: Tensor, scalars) -> Tensor:
    """x's rows kept by the scalar block's keep bits, the others 0."""
    keep = keep_bits_ref(x.shape[0], scalars, x.device)
    return torch.where(keep[:, None], x, 0.0)


def sample_mask_ref(n: int, batch_size: int, seed,
                    device="cpu") -> Tensor:
    """(n,) bool keep bits; exactly min(batch_size, n) are set."""
    return keep_bits_ref(n, sample_scalars(n, batch_size, [seed])[0], device)


def sample_mask_masked_ref(n: int, batch_size: int, seed, n_t: int,
                           device="cpu") -> Tensor:
    """(n,) bool keep bits over a padded buffer; min(batch_size, n_t) set,
    all below n_t."""
    return keep_bits_ref(n, sample_scalars(n, batch_size, [seed], [n_t])[0],
                         device)


def _hash_order(seed, n: int, device) -> Tensor:
    """Row indices in (hash, row) order (a stable sort of the hashes)."""
    h = counter_hash(int(seed), torch.arange(n, dtype=torch.int64,
                                             device=device))
    return torch.sort(h, stable=True).indices


def lstsq_grad_sampled_ref(x: Tensor, w: Tensor, y: Tensor, seed,
                           batch_size: int) -> Tensor:
    """Unbiased seeded-minibatch gradient (n/bsz) * 2 X_S^T (X_S w - y_S).

    bsz = min(batch_size, n); S is the prefix of the (hash, row) order,
    gathered, so the contraction is O(bsz d).  batch_size >= n is
    `lstsq_grad_ref`, the same call.
    """
    n = x.shape[0]
    bsz = min(batch_size, n)
    if bsz >= n:
        return lstsq_grad_ref(x, w, y)
    sel = _hash_order(seed, n, x.device)[:bsz]
    x32 = x[sel].to(torch.float32)
    y32 = y[sel].to(torch.float32)
    r = x32 @ w.to(torch.float32) - y32
    return ((2.0 * (n / bsz)) * (x32.T @ r)).to(w.dtype)


def lstsq_grad_sampled_masked_ref(x: Tensor, w: Tensor, y: Tensor, seed,
                                  batch_size: int, n_t: int) -> Tensor:
    """Ragged minibatch gradient (n_t/bsz) * 2 X_S^T (X_S w - y_S).

    bsz = min(batch_size, n_t).  The gather keeps a static height of
    bsz_max = min(batch_size, n) rows in (hash, row) order, valid rows
    first (stable), and rows at rank >= bsz are masked out of the
    RESIDUAL, never out of the gathered X.  The scale is
    2 * (f32(n_t) / f32(max(bsz, 1))): for integers below 2^24 it has the
    bits of the uniform path's 2 * (n / bsz) rounded to float32, so with
    n_t == n this is `lstsq_grad_sampled_ref` bitwise; n_t == 0 gives the
    zero vector.  batch_size >= n is `lstsq_grad_masked_ref`.
    """
    n = x.shape[0]
    bsz_max = min(batch_size, n)
    if bsz_max >= n:
        return lstsq_grad_masked_ref(x, w, y, n_t)
    order = _hash_order(seed, n, x.device)
    invalid = (order >= n_t).to(torch.uint8)
    sel = order[torch.sort(invalid, stable=True).indices[:bsz_max]]
    bsz = min(batch_size, int(n_t))
    x32 = x[sel].to(torch.float32)
    y32 = y[sel].to(torch.float32)
    row_ok = torch.arange(bsz_max, device=x.device) < bsz
    r = torch.where(row_ok, x32 @ w.to(torch.float32) - y32, 0.0)
    scale = float(2 * (np.float32(n_t) / np.float32(max(bsz, 1))))
    return (scale * (x32.T @ r)).to(w.dtype)


def task_index(t: int, num_t: int) -> int:
    """The task a dynamic index by id t picks among num_t, as the
    reference's `lax.dynamic_index_in_dim` picks it: a negative id counts
    from the end, then the id is clamped into [0, num_t)."""
    if t < 0:
        t += num_t
    return min(max(t, 0), num_t - 1)


def lstsq_grad_sampled_batch_ref(xs: Tensor, ys: Tensor, tasks: Tensor,
                                 w_rows: Tensor, scalars: Tensor,
                                 batch_size: int) -> Tensor:
    """(B, d) minibatch gradients of B events: row e is
    `lstsq_grad_sampled_masked_ref` of task tasks[e] at w_rows[e] with the
    seed and n_t of scalars[e] (the event loop of the reference's step,
    each row with the single event's bits).  An id outside [0, T) picks
    its task by `task_index`."""
    rows = []
    for e, t in enumerate(task_index(int(t), xs.shape[0])
                          for t in tasks.tolist()):
        seed, _, _, n_t = (int(s) for s in scalars[e].tolist())
        rows.append(lstsq_grad_sampled_masked_ref(xs[t], w_rows[e], ys[t],
                                                  seed, batch_size, n_t))
    return torch.stack(rows)

# ------------------------------------------------------------ attention ---

NEG_INF = -1e30


def sliding_flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                                window: int | None, causal: bool = True,
                                softcap: float | None = None) -> Tensor:
    """O(S^2) attention with an optional sliding window and logit softcap.

    q, k, v: (S, H, D), one batch element, kv heads already repeated to H.
    Key j is kept for query i iff (not causal or j <= i) and (no window or
    j > i - window).  Returns (S, H, D) in q's dtype.
    """
    s, _, d = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    logits = torch.einsum("qhd,khd->hqk", q.float(), k.float()) \
        * scale.to(q.device)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    logits = torch.where(mask[None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("hqk,khd->qhd", probs, v.float())
    return out.to(q.dtype)


def mha_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
            window: int | None = None, softcap: float | None = None,
            q_offset: int = 0, kv_valid_len: int | None = None,
            kv_chunk: int = 1024, p_dtype: torch.dtype | None = None
            ) -> Tensor:
    """Online-softmax attention over kv chunks (the reference model's `mha`).

    q: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd); query head h reads kv head
    h // (H / Hkv).  Query row r sits at position q_offset + r; key j is
    kept iff j < kv_valid_len (default Skv), and (not causal or j <= i),
    and (no window or j > i - window).  Masked logits are NEG_INF; the
    running (m, l, acc) are float32, and the output is acc / max(l, 1e-30)
    in q's dtype.  `p_dtype` (default None: float32) rounds each chunk's
    p to that dtype before the P V product, l still summing the float32 p:
    with kv_chunk 64 and bfloat16 that is the order and the rounding of the
    tensor-core route (csrc/flash_attention_sm90.cu), for chip_smoke.py.
    """
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, hd).float()
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    scale = scale.to(dev)
    kc = min(kv_chunk, skv)
    n_chunks = (skv + kc - 1) // kc
    valid = skv if kv_valid_len is None else int(kv_valid_len)
    q_pos = int(q_offset) + torch.arange(sq, device=dev)
    neg = torch.tensor(NEG_INF, device=dev)

    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        lo, hi = c * kc, min((c + 1) * kc, skv)
        k_c = k[:, lo:hi].float()
        v_c = v[:, lo:hi].float()
        if hi - lo < kc:           # the reference pads the last chunk
            pad = (0, 0, 0, 0, 0, kc - (hi - lo))
            k_c = torch.nn.functional.pad(k_c, pad)
            v_c = torch.nn.functional.pad(v_c, pad)
        kv_pos = lo + torch.arange(kc, device=dev)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_c) * scale
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        mask = (kv_pos[None, :] < valid).expand(sq, kc)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        logits = torch.where(mask, logits, neg)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        if p_dtype is not None:
            p = p.to(p_dtype).float()
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                   v_c)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def mha_split_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                  window: int | None = None, softcap: float | None = None,
                  q_offset: int = 0, kv_valid_len: int | None = None,
                  num_splits: int, chunk: int | None = None) -> Tensor:
    """`mha_ref`'s function computed as the split route computes it
    (csrc/flash_decode.cu): split s takes the keys [s * chunk, min((s + 1)
    * chunk, kv_valid_len)) (chunk default ceil(Skv / num_splits), so
    splits past kv_valid_len are empty) and gives its (m_s, l_s, acc_s) in
    float32, a masked key weighing 0, a split with no kept key m_s = -1e30,
    l_s = 0, acc_s = 0; the splits are then merged in order: M = max m_s,
    L = sum l_s exp(m_s - M), o = sum acc_s exp(m_s - M) / max(L, 1e-30),
    the acc sum in the combine kernel's order (flash_attention.SPLIT_RUNS
    interleaved runs over the splits, each in order, then the runs in
    order; L is summed in split order, the kernel's tree order being a
    rounding apart).  A row
    with no kept key at all gives 0.  For tests and chip_smoke.py; the
    port's main path never calls it."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    dev = q.device
    valid = skv if kv_valid_len is None else int(kv_valid_len)
    chunk = -(-skv // num_splits) if chunk is None else int(chunk)
    if num_splits < 1 or num_splits * chunk < valid:
        raise ValueError(f"mha_split_ref: {num_splits} splits of {chunk} "
                         f"keys do not cover kv_valid_len {valid}")
    qg = q.reshape(b, sq, hkv, g, hd).float()
    scale = (1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))).to(dev)
    q_pos = int(q_offset) + torch.arange(sq, device=dev)
    parts = []
    for s in range(num_splits):
        lo, hi = s * chunk, min((s + 1) * chunk, valid)
        m_s = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                         device=dev)
        l_s = torch.zeros_like(m_s)
        acc_s = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32,
                            device=dev)
        if hi > lo:
            k_c, v_c = k[:, lo:hi].float(), v[:, lo:hi].float()
            kv_pos = lo + torch.arange(hi - lo, device=dev)
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_c) * scale
            if softcap is not None:
                logits = softcap * torch.tanh(logits / softcap)
            mask = torch.ones((sq, hi - lo), dtype=torch.bool, device=dev)
            if causal:
                mask &= kv_pos[None, :] <= q_pos[:, None]
            if window is not None:
                mask &= kv_pos[None, :] > q_pos[:, None] - window
            logits = torch.where(mask, logits,
                                 torch.tensor(NEG_INF, device=dev))
            m_s = logits.amax(dim=-1)
            p = torch.where(mask, torch.exp(logits - m_s[..., None]), 0.0)
            l_s = p.sum(dim=-1)
            acc_s = torch.einsum("bhgqk,bkhd->bhgqd", p, v_c)
        parts.append((m_s, l_s, acc_s))
    big = torch.stack([m_s for m_s, _, _ in parts]).amax(dim=0)
    den = torch.zeros_like(big)
    n_runs = flash_attention.SPLIT_RUNS
    runs = [torch.zeros_like(parts[0][2]) for _ in range(n_runs)]
    for s, (m_s, l_s, acc_s) in enumerate(parts):
        w = torch.exp(m_s - big)
        den = den + l_s * w
        runs[s % n_runs] = runs[s % n_runs] + acc_s * w[..., None]
    acc = runs[0]
    for run in runs[1:]:
        acc = acc + run
    out = acc / torch.clamp_min(den, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


# ------------------------------------------------------------------ WKV ---

def rwkv6_scan_ref(r: Tensor, k: Tensor, v: Tensor, w: Tensor,
                   u: Tensor) -> Tensor:
    """RWKV-6 (Finch) WKV recurrence of one sequence, from a zero state.

    r, k, v, w: (S, H, D), w the per-step decay in (0, 1); u: (H, D), the
    bonus of the current token.  With S_h in R^{D x D} the state before
    token t:
        out_t = r_t . (S + u * k_t v_t^T);   S <- diag(w_t) S + k_t v_t^T
    in float32.  Returns (S, H, D) in r's dtype.
    """
    out, _ = wkv_ref(r[None], k[None], v[None], w[None], u, None)
    return out[0].to(r.dtype)


def wkv_ref(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
            state: Tensor | None) -> tuple[Tensor, Tensor]:
    """The WKV recurrence of `rwkv6_scan_ref`, batched and from a state: the
    exact definition of the CUDA kernel.

    r, k, v, w: (B, L, H, D); u: (H, D); state: (B, H, D, D) (None: zeros),
    the state before the first token.  Token by token in float32, as the
    reference's decode step writes it: kv = k v^T, out = r . (S + u kv),
    S <- w S + kv.  Returns (out (B, L, H, D) float32, the state after the
    last token (B, H, D, D) float32); `state` itself is not written.
    """
    b, ell, h, d = r.shape
    s = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if state is None else state.to(torch.float32))
    u32 = u.to(torch.float32)[None, :, :, None]
    r32, k32, v32, w32 = (t.to(torch.float32) for t in (r, k, v, w))
    outs = []
    for t in range(ell):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]       # (B,H,D,D)
        outs.append(torch.einsum("bhd,bhde->bhe", r32[:, t], s + u32 * kv))
        s = w32[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def wkv_chunked_ref(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                    chunk: int, state0: Tensor | None = None
                    ) -> tuple[Tensor, Tensor]:
    """The reference model's chunked WKV (`_wkv_chunked`), step for step.

    r, k, v, w: (B, L, H, D); u: (H, D); state0: (B, H, D, D) or None.
    The sequence is padded to a multiple of the chunk with k = 0 and w = 1
    (no contribution, no decay); within a chunk the decays are carried as
    log-space cumulative sums, re-centred at half the chunk's total, the
    intra-chunk terms are two einsums, and a loop over chunks carries the
    state.  Returns (out (B, L, H, D) float32, final state float32).
    Agrees with `wkv_ref` to float32 rounding (exp/log of cumulative decays
    against repeated products); for decays whose chunk total underflows
    (w near 1e-3 over 128 steps) it overflows, as the reference does.
    """
    b, ell0, h, d = r.shape
    q = min(chunk, ell0)
    pad = (-ell0) % q
    if pad:
        pads = (0, 0, 0, 0, 0, pad)
        r, k, v = (torch.nn.functional.pad(t, pads) for t in (r, k, v))
        w = torch.nn.functional.pad(w, pads, value=1.0)
    ell = ell0 + pad
    nc = ell // q

    def rs(t):
        return t.reshape(b, nc, q, h, d).to(torch.float32)

    rc, kc, vc, wc = rs(r), rs(k), rs(v), rs(w)
    logw = torch.log(torch.clamp_min(wc, 1e-30))
    cum = torch.cumsum(logw, dim=2)
    cum_excl = cum - logw
    mid = 0.5 * cum[:, :, -1:]
    r_intra = rc * torch.exp(cum_excl - mid)
    k_intra = kc * torch.exp(mid - cum)
    att = torch.einsum("bcshd,bcthd->bchst", r_intra, k_intra)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    att = torch.where(causal, att, 0.0)
    y_intra = torch.einsum("bchst,bcthd->bcshd", att, vc)
    bonus = torch.einsum("bcshd,hd,bcshd->bcsh", rc, u.to(torch.float32), kc)
    y_intra = y_intra + bonus[..., None] * vc

    k_tail = kc * torch.exp(cum[:, :, -1:] - cum)
    chunk_kv = torch.einsum("bcthd,bcthe->bchde", k_tail, vc)
    chunk_decay = torch.exp(cum[:, :, -1])                # (B, nc, H, D)
    s = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
         if state0 is None else state0.to(torch.float32))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, :, None] + chunk_kv[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                 # (B, nc, H, D, D)
    y_inter = torch.einsum("bcshd,bchde->bcshe", rc * torch.exp(cum_excl),
                           s_prevs)
    out = (y_intra + y_inter).reshape(b, ell, h, d)[:, :ell0]
    return out, s


OPERANDS = ("float32", "tf32", "bfloat16")


def round_operand(x: Tensor, operands: str) -> Tensor:
    """x (float32) as a tensor-core operand of `operands`: float32 as it
    is; tf32 rounded to 10 mantissa bits, to nearest with ties away from
    zero (`cvt.rna.tf32.f32`); bfloat16 to nearest even."""
    if operands == "float32":
        return x
    if operands == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if operands == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"operands must be one of {OPERANDS}, got {operands!r}")


WKV_SUB = 16                # csrc/rwkv6_chunked.cu's SUB: tokens a state step


def wkv_subchunk_ref(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                     state: Tensor | None, *,
                     operands: str = "tf32") -> tuple[Tensor, Tensor]:
    """The WKV in the factorisation of the chunked route
    (csrc/rwkv6_chunked.cu), step for step.

    r, k, v, w: (B, L, H, D); u: (H, D); state: (B, H, D, D) or None.  The
    tokens are cut into sub-chunks of `sub` = WKV_SUB (the last padded
    with r = k = v = 0, w = 1: no contribution, no decay).  Within
    a sub-chunk, with S the state at its start, every decay is a running
    product of the w's (never a quotient of cumulative decays, so nothing
    overflows where the decays underflow):
        E_s = prod_{j<s} w_j,  F_t = prod_{t<j<sub} w_j,  E = prod_j w_j
        A[s, t] = sum_i r_s,i k_t,i prod_{t<j<s} w_j,i  (t < s)
        A[s, s] = sum_i r_s,i u_i k_s,i
        out_s = (r_s * E_s) . S + sum_{t<=s} A[s, t] v_t
        S <- diag(E) S + sum_t (k_t * F_t) v_t^T
    A pair in one block of 4 tokens is summed as it stands; a pair across
    blocks is factored at the start g of the query's block, as the
    product X_s . Y_t of X_s = r_s prod_{g<=j<s} w_j and Y_t = k_t
    prod_{t<j<g} w_j (the decays of t's block, then each whole block
    between, multiplied in that order).  The products' operands are
    rounded as the kernel rounds them (`round_operand(., operands)`):
    r * E, X, Y, A, v and k * F; S goes as two terms, hi = round(S) times
    r * E, and lo = S - hi times r * E, both in bfloat16 (float32 when
    `operands` is float32); sums are float32.  Returns (out (B, L,
    H, D) float32, the final state float32); `state` itself is not written.
    """
    sub = WKV_SUB
    b, ell, h, d = r.shape
    pad = (-ell) % sub
    r32, k32, v32, w32 = (t.to(torch.float32) for t in (r, k, v, w))
    if pad:
        pads = (0, 0, 0, 0, 0, pad)
        r32, k32, v32 = (torch.nn.functional.pad(t, pads)
                         for t in (r32, k32, v32))
        w32 = torch.nn.functional.pad(w32, pads, value=1.0)
    n = (ell + pad) // sub

    def split(t):                       # (B, L, H, D) -> (B, H, n, sub, D)
        return t.reshape(b, n, sub, h, d).permute(0, 3, 1, 2, 4)

    rs, ks, vs, ws = split(r32), split(k32), split(v32), split(w32)
    u32 = u.to(torch.float32)[None, :, None, :]          # (1, H, 1, D)

    prod = torch.ones_like(ws[..., 0, :])                 # running products
    e_rows = []
    for s in range(sub):
        e_rows.append(prod)
        prod = prod * ws[..., s, :]
    e_all = prod                                          # (B, H, n, D)
    prod = torch.ones_like(prod)
    f_rows = [None] * sub
    for s in reversed(range(sub)):
        f_rows[s] = prod
        prod = prod * ws[..., s, :]
    rt = round_operand(rs * torch.stack(e_rows, dim=-2), operands)
    kt = round_operand(ks * torch.stack(f_rows, dim=-2), operands)

    a = torch.zeros((b, h, n, sub, sub), dtype=torch.float32,
                    device=r.device)
    for t in range(sub):                # within blocks of 4, and the bonus
        p = ks[..., t, :]
        a[..., t, t] = (rs[..., t, :] * u32 * p).sum(-1)
        for s in range(t + 1, 4 * (t // 4) + 4):
            a[..., s, t] = (rs[..., s, :] * p).sum(-1)
            p = p * ws[..., s, :]
    x_rows, block_w = [], []            # across blocks
    for g in range(0, sub, 4):
        prod = torch.ones_like(ws[..., 0, :])
        for s in range(g, g + 4):
            x_rows.append(rs[..., s, :] * prod)
            prod = prod * ws[..., s, :]
        prod = torch.ones_like(prod)    # the block's product, last w first
        for s in reversed(range(g, g + 4)):
            prod = prod * ws[..., s, :]
        block_w.append(prod)
    xs = round_operand(torch.stack(x_rows, dim=-2), operands)
    for t in range(sub - 4):
        prod = torch.ones_like(ws[..., 0, :])
        for j in reversed(range(t + 1, 4 * (t // 4) + 4)):
            prod = prod * ws[..., j, :]
        y = ks[..., t, :] * prod
        for g in range(4 * (t // 4) + 4, sub, 4):
            if g > 4 * (t // 4) + 4:
                y = y * block_w[g // 4 - 1]
            yr = round_operand(y, operands)
            a[..., g:g + 4, t] = torch.einsum("bhnsd,bhnd->bhns",
                                              xs[..., g:g + 4, :], yr)
    a = round_operand(a, operands)
    vo = round_operand(vs, operands)

    st = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
          if state is None else state.to(torch.float32))
    lo_operands = "float32" if operands == "float32" else "bfloat16"
    outs = []
    for c in range(n):
        s_hi = round_operand(st, operands)
        s_lo = round_operand(st - s_hi, lo_operands)
        outs.append((torch.einsum("bhsi,bhij->bhsj", rt[:, :, c], s_hi)
                     + torch.einsum("bhsi,bhij->bhsj",
                                    round_operand(rt[:, :, c], lo_operands),
                                    s_lo))
                    + torch.einsum("bhst,bhtj->bhsj", a[:, :, c],
                                   vo[:, :, c]))
        st = st * e_all[:, :, c, :, None] + torch.einsum(
            "bhti,bhtj->bhij", kt[:, :, c], vo[:, :, c])
    out = torch.stack(outs, dim=2)                        # (B, H, n, sub, D)
    out = out.permute(0, 2, 3, 1, 4).reshape(b, n * sub, h, d)
    return out[:, :ell], st


def wkv_inplace_ref(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                    state: Tensor, *, chunk: int) -> Tensor:
    """`ops.wkv`'s contract in plain PyTorch: `wkv_chunked_ref` from
    `state`, whose final state is written back into `state`; returns the
    output (B, L, H, D) in r's dtype."""
    out, s = wkv_chunked_ref(r, k, v, w, u, chunk, state)
    state.copy_(s)
    return out.to(r.dtype)
