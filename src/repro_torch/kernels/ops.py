"""Dispatch between the CUDA kernels and their plain PyTorch versions.

Port of `repro/kernels/ops.py`, with the device of the tensor in place of
`_on_tpu()`: a CPU tensor goes to the plain version in `ref`, a CUDA
tensor goes to the kernel, and anything else raises.  Nothing falls back:
a CUDA tensor reaches its kernel or an exception.

Each kernel module keeps an integer `launches`, raised by one at each
launch; `launch_counts` reads them and `reset_launch_counts` zeroes them,
so a run can show which kernels its path went through.  Flash attention
and the WKV also count each of their routes (`flash_attention.route_counts`,
`rwkv6_scan.route_counts`).

`mha` is differentiable where grad is on and an input asks for it: a
`torch.autograd.Function` whose forward takes the same routes as without
grad and whose backward is the `flash_attention_bwd` kernel for CUDA
tensors and its plain version (`ref.mha_bwd_ref`) for CPU tensors.  Under
`torch.inference_mode()` or `no_grad` nothing changes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import amtl_event as _amtl_event
from repro_torch.kernels import amtl_event_batch as _amtl_event_batch
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import flash_attention_bwd as _flash_attention_bwd
from repro_torch.kernels import gauss_sketch as _gauss_sketch
from repro_torch.kernels import km_update as _km_update
from repro_torch.kernels import l21_prox as _l21_prox
from repro_torch.kernels import lstsq_grad as _lstsq_grad
from repro_torch.kernels import lstsq_grad_sampled as _lstsq_grad_sampled
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as _rwkv6_scan
from repro_torch.kernels import sample_mask as _sample_mask
from repro_torch.kernels import svt_reconstruct as _svt_reconstruct

KERNELS = {
    "amtl_event": _amtl_event,
    "amtl_event_batch": _amtl_event_batch,
    "gauss_sketch": _gauss_sketch,
    "svt_reconstruct": _svt_reconstruct,
    "lstsq_grad_sampled": _lstsq_grad_sampled,
    "sample_mask": _sample_mask,
    "lstsq_grad": _lstsq_grad,
    "flash_attention": _flash_attention,
    "flash_attention_bwd": _flash_attention_bwd,
    "rwkv6_scan": _rwkv6_scan,
    "km_update": _km_update,
    "l21_prox": _l21_prox,
}


def _on_cuda(name: str, where: torch.Tensor | torch.device | str) -> bool:
    dev = where.device if isinstance(where, torch.Tensor) \
        else torch.device(where)
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {dev}")


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
    _flash_attention.reset_route_counts()
    _flash_attention_bwd.reset_route_counts()
    _rwkv6_scan.reset_route_counts()


def km_update(v: torch.Tensor, p: torch.Tensor, g: torch.Tensor, eta: float,
              eta_k: float) -> torch.Tensor:
    """Fused Eq. III.4 elementwise, v + eta_k*(p - eta*g - v) in the fma
    form, on contiguous tensors of one shape (the dense engine's column)."""
    if _on_cuda("km_update", v):
        return _km_update.km_update(v, p, g, eta, eta_k)
    return ref.km_update_ref(v, p, g, eta, eta_k)


def km_update_slot(ring: torch.Tensor, src: int, dst: int, t: int,
                   p_t: torch.Tensor, g_t: torch.Tensor, eta: float,
                   eta_k: float) -> None:
    """The dense engine's event on its float32 (depth, d, T) ring, in
    place: ring[dst] = ring[src] with column t updated by Eq. III.4 in the
    fma form (src == dst: column t alone).  One `km_update` launch on the
    card."""
    if _on_cuda("km_update", ring):
        _km_update.km_update_slot(ring, src, dst, t, p_t, g_t, eta, eta_k)
    else:
        ref.km_update_slot_ref(ring, src, dst, t, p_t, g_t, eta, eta_k)


def l21_prox(w: torch.Tensor, t: float) -> torch.Tensor:
    """Row-group soft threshold of a contiguous (d, T) matrix:
    w_i * max(0, 1 - t/max(||w_i||_2, 1e-12)), in float32."""
    if _on_cuda("l21_prox", w):
        return _l21_prox.l21_prox(w, t)
    return ref.l21_prox_ref(w, t)


def amtl_event(v_t: torch.Tensor, p_t: torch.Tensor, g_t: torch.Tensor,
               eta: float, eta_k: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused delta-ring column event: returns (v_new, undo-log entry)."""
    if _on_cuda("amtl_event", v_t):
        return _amtl_event.amtl_event(v_t, p_t, g_t, eta, eta_k)
    return ref.amtl_event_ref(v_t, p_t, g_t, eta, eta_k)


def amtl_event_inplace(v: torch.Tensor, t: int, p_t: torch.Tensor,
                       g_t: torch.Tensor, eta: float, eta_k: float,
                       ring: torch.Tensor, slot: int) -> None:
    """The delta engine's column event on its own state, in place: column
    t of the float32 (d, T) iterate v updated, its pre-write bits into
    ring[slot] of the (depth, d) undo ring.  One `amtl_event` launch on
    the card."""
    if _on_cuda("amtl_event", v):
        _amtl_event.amtl_event_inplace(v, t, p_t, g_t, eta, eta_k, ring, slot)
    else:
        ref.amtl_event_inplace_ref(v, t, p_t, g_t, eta, eta_k, ring, slot)


def amtl_event_batch(v: torch.Tensor, p_cols: torch.Tensor,
                     g_cols: torch.Tensor, tasks: torch.Tensor, eta: float,
                     eta_ks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched multi-event update of `v` IN PLACE: returns (v, undo (B, d)).

    Within-batch duplicate tasks serialize in event order; ids >= T are
    dropped (see `ref.amtl_event_batch_ref`).
    """
    if _on_cuda("amtl_event_batch", v):
        return _amtl_event_batch.amtl_event_batch(v, p_cols, g_cols, tasks,
                                                  eta, eta_ks)
    return ref.amtl_event_batch_ref(v, p_cols, g_cols, tasks, eta, eta_ks)


def amtl_event_batch_sharded(v_local: torch.Tensor, p_cols: torch.Tensor,
                             g_cols: torch.Tensor,
                             local_tasks: torch.Tensor, eta: float,
                             eta_ks: torch.Tensor) -> tuple[torch.Tensor,
                                                           torch.Tensor]:
    """A rank's batched multi-event update of its (d, n_local) block, in
    place (the sharded engine): `amtl_event_batch` with the local ids of
    `ref.shard_local_tasks`, whose sentinel n_local marks another rank's
    event.  The kernel, like the plain version, drops a sentinel event: it
    never writes the block, and its undo entry is the reference's."""
    return amtl_event_batch(v_local, p_cols, g_cols, local_tasks, eta,
                            eta_ks)


def gauss_sketch(w: torch.Tensor, seed: int, row_offset: int,
                 p: int) -> torch.Tensor:
    """(d, p) float32 randomized-SVT sketch W @ Omega."""
    if _on_cuda("gauss_sketch", w):
        return _gauss_sketch.gauss_sketch(w, seed, row_offset, p)
    return ref.gauss_sketch_ref(w, seed, row_offset, p)


def svt_reconstruct(qu: torch.Tensor, s: torch.Tensor,
                    vt: torch.Tensor) -> torch.Tensor:
    """Thresholded low-rank SVT apply (QU * sigma) @ V^T: (d, m)."""
    if _on_cuda("svt_reconstruct", qu):
        return _svt_reconstruct.svt_reconstruct(qu, s, vt)
    return ref.svt_reconstruct_ref(qu, s, vt)


def lstsq_grad(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
               n_t: int | None = None) -> torch.Tensor:
    """Fused 2 X^T (X w - y); a host `n_t` masks a ragged buffer's rows
    >= n_t out of the residual."""
    if _on_cuda("lstsq_grad", x):
        return _lstsq_grad.lstsq_grad(x, w, y, n_t)
    if n_t is None:
        return ref.lstsq_grad_ref(x, w, y)
    return ref.lstsq_grad_masked_ref(x, w, y, n_t)


def lstsq_grad_task(xs: torch.Tensor, ys: torch.Tensor, t: int,
                    w: torch.Tensor,
                    row_counts: torch.Tensor | None = None) -> torch.Tensor:
    """(d,) full gradient of task t (a host id) at w on the buffers xs
    (T, n, d) and ys (T, n), rows >= row_counts[t] masked (read on the
    device; None: every row).  On the card one `lstsq_grad` launch, the
    B = 1 form of `lstsq_grad_batch`."""
    if _on_cuda("lstsq_grad", xs):
        return _lstsq_grad.lstsq_grad_task(xs, ys, t, w, row_counts)
    return ref.lstsq_grad_task_ref(xs, ys, t, w, row_counts)


def lstsq_grad_batch(xs: torch.Tensor, ys: torch.Tensor, tasks: torch.Tensor,
                     w_rows: torch.Tensor,
                     row_counts: torch.Tensor | None = None) -> torch.Tensor:
    """(B, d) full gradients of B events in one call: row e is the
    gradient of task tasks[e] ((B,) int32 on the buffers' device) at
    w_rows[e], rows >= row_counts[t] masked ((T,) int32 on the device, or
    None).  On the card one launch, no host read of the tasks or counts;
    row e has the bits of `lstsq_grad_task` of event e."""
    if _on_cuda("lstsq_grad", xs):
        return _lstsq_grad.lstsq_grad_batch(xs, ys, tasks, w_rows, row_counts)
    return ref.lstsq_grad_batch_ref(xs, ys, tasks, w_rows, row_counts)


def lstsq_grad_sampled(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                       scalars, batch_size: int) -> torch.Tensor:
    """Unbiased seeded-minibatch gradient (n_t/bsz) * 2 X_S^T (X_S w - y_S)
    for the event's host scalar block (seed, cut_h, cut_i, n_t), planned by
    `ref.sample_scalars`.  batch_size >= n is the masked full gradient
    (the plain version's own short cut; the kernel's cutoff saturates)."""
    if _on_cuda("lstsq_grad_sampled", x):
        return _lstsq_grad_sampled.lstsq_grad_sampled(x, w, y, scalars,
                                                      batch_size)
    seed, _, _, n_t = (int(s) for s in scalars)
    return ref.lstsq_grad_sampled_masked_ref(x, w, y, seed, batch_size, n_t)


def lstsq_grad_sampled_batch(xs: torch.Tensor, ys: torch.Tensor,
                             tasks: torch.Tensor, w_rows: torch.Tensor,
                             scalars: torch.Tensor,
                             batch_size: int) -> torch.Tensor:
    """(B, d) minibatch gradients of B events in one call: row e is
    `lstsq_grad_sampled` of task tasks[e] (int32) at w_rows[e] with the
    scalar block scalars[e] ((B, 4) uint32), on the buffers xs (T, n, d)
    and ys (T, n).  On the card one launch; row e has the bits of the
    single event's call."""
    if _on_cuda("lstsq_grad_sampled", xs):
        return _lstsq_grad_sampled.lstsq_grad_sampled_batch(
            xs, ys, tasks, w_rows, scalars, batch_size)
    return ref.lstsq_grad_sampled_batch_ref(xs, ys, tasks, w_rows, scalars,
                                            batch_size)


def sample_mask(n: int, scalars, device: torch.device | str) -> torch.Tensor:
    """(n,) bool minibatch keep bits of a host scalar block, on `device`;
    exactly min(batch_size, n_t) are set, all below n_t."""
    if _on_cuda("sample_mask", device):
        return _sample_mask.sample_mask(n, scalars, device)
    return ref.keep_bits_ref(n, scalars, device)


def sample_rows(x_t: torch.Tensor, scalars) -> torch.Tensor:
    """(n, d) float32 rows of x_t kept by the host scalar block's keep
    bits, the dropped rows 0: `where(keep_bits[:, None], x_t, 0)` in one
    call.  On the card one `sample_mask` launch (the keep bits are formed
    where the rows are written)."""
    if _on_cuda("sample_mask", x_t):
        return _sample_mask.sample_rows(x_t, scalars)
    return ref.sample_rows_ref(x_t, scalars)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """q (S, H, hd); k, v (S, Hkv, hd): attention of one sequence with GQA,
    causal and sliding-window masks and a logit softcap; (S, H, hd)."""
    if _on_cuda("flash_attention", q):
        return _flash_attention.flash_attention(
            q[None], k[None], v[None], causal=causal, window=window,
            softcap=softcap)[0]
    rep = q.shape[1] // k.shape[1]
    return ref.sliding_flash_attention_ref(
        q, k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1),
        window=window, causal=causal, softcap=softcap)


def _mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: dict, kv_chunk: int) -> torch.Tensor:
    if _on_cuda("flash_attention", q):
        return _flash_attention.flash_attention(
            q, k, v, causal=mask["causal"], window=mask["window"],
            softcap=mask["softcap"], q_offset=mask["q_offset"],
            kv_len=mask["kv_valid_len"])
    return ref.mha_ref(q, k, v, kv_chunk=kv_chunk, **mask)


def mha_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, do: torch.Tensor, *, causal: bool,
                 window: int | None = None, softcap: float | None = None,
                 q_offset: int = 0, kv_valid_len: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `mha` at q, k, v with output o and its gradient do:
    the `flash_attention_bwd` kernel on the card, its plain version on the
    CPU."""
    if _on_cuda("flash_attention_bwd", q):
        return _flash_attention_bwd.flash_attention_bwd(
            q, k, v, o, do, causal=causal, window=window, softcap=softcap,
            q_offset=q_offset, kv_len=kv_valid_len)
    return ref.mha_bwd_ref(q, k, v, o, do, causal=causal, window=window,
                           softcap=softcap, q_offset=q_offset,
                           kv_valid_len=kv_valid_len)


class _MHA(torch.autograd.Function):
    """`mha` with its gradient: the forward's route, then `mha_backward`
    on the saved q, k, v and output."""

    @staticmethod
    def forward(ctx, q, k, v, mask, kv_chunk):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = _mha_forward(q, k, v, mask, kv_chunk)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = mha_backward(q, k, v, out, do.contiguous(), **ctx.mask)
        return dq, dk, dv, None, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
        window: int | None = None, softcap: float | None = None,
        q_offset: int = 0, kv_valid_len: int | None = None,
        kv_chunk: int = 1024) -> torch.Tensor:
    """The model's attention: q (B, Sq, H, hd), k, v (B, Skv, Hkv, hd) ->
    (B, Sq, H, hd), with a query offset and a valid key count (host ints).
    `kv_chunk` is the plain version's chunk of keys (the order of its sums);
    on the card `flash_attention.route` picks the kernel, whatever it is.
    Differentiable when grad is on and q, k or v requires it."""
    mask = dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset, kv_valid_len=kv_valid_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _MHA.apply(q, k, v, mask, kv_chunk)
    return _mha_forward(q, k, v, mask, kv_chunk)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, v, w (S, H, D); u (H, D): the WKV recurrence of one sequence
    from a zero state; (S, H, D) in r's dtype.  On the card w and u are
    taken as float32 (exact from bfloat16) and the kernel of
    `rwkv6_scan.route` runs with B 1."""
    if _on_cuda("rwkv6_scan", r):
        s, h, d = r.shape
        state = torch.zeros((1, h, d, d), dtype=torch.float32,
                            device=r.device)
        return _rwkv6_scan.wkv(r[None], k[None], v[None],
                               w.float().contiguous()[None],
                               u.float().contiguous(), state)[0]
    return ref.rwkv6_scan_ref(r, k, v, w, u)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """The model's WKV: r, k, v (B, L, H, D), w (B, L, H, D) float32, u
    (H, D) float32, from `state` (B, H, D, D) float32, which is overwritten
    with the state after the last token; returns out (B, L, H, D) in r's
    dtype.  `chunk` is the plain version's chunk (the order of its sums);
    on the card `rwkv6_scan.route` picks the kernel (the sub-chunked
    tensor-core route for bf16 prefill, the token-by-token recurrence for
    the rest) whatever it is."""
    if _on_cuda("rwkv6_scan", r):
        return _rwkv6_scan.wkv(r, k, v, w, u, state)
    return ref.wkv_inplace_ref(r, k, v, w, u, state, chunk=chunk)
