"""Attention: chunked online-softmax (flash-style) attention and the decode
path, on torch tensors. Port of ``repro.models.attention``.

``flash_attention`` is the reference's algorithm: online softmax over KV
chunks carries the running (max, denom, acc) triple, so no ``(B, H, T,
S)`` score block is ever held. Its gradient is the FlashAttention-2
backward (Dao, arXiv:2307.08691) as one ``torch.autograd.Function``: the
forward saves only ``(q, k, v, out, lse)`` and the backward recomputes each
probability block from the log-sum-exp, as the reference's ``custom_vjp``
does. Autograd through the chunk loops would save every score block
instead (O(T*S) memory). The Function calls ``kernels.ops``: on the card
the forward and the backward are the hand-written CUDA kernel
(``kernels/csrc/flash_attention.cu``), on the CPU (and on meta tensors)
its plain version (``kernels.ref.flash_attention_fwd_ref`` / ``_bwd_ref``),
the reference's chunk loops written eagerly.

Kept from the reference: ``NEG_INF = -1e30`` (not ``-inf``), the
probabilities rounded to ``q``'s dtype before the PV product, ``l_safe =
max(l, 1e-37)``, ``ds`` rounded to ``q``'s dtype, causal masking in global
positions (query row 0 at ``q_start``, by default ``S - T``), a ``v`` head
dim that may differ from ``q``'s (MLA), and the fall back to
``attention_dense`` when ``T % q_chunk`` or ``S % kv_chunk`` is nonzero.

Two things differ in how, not in what. GQA heads share their KV head
through the matmul (the ``n_rep`` query heads of a KV head are rows of one
product) instead of a repeated copy, so the backward's ``dk``/``dv`` sum
the heads of a group in float32 inside the product where the reference
rounds each head's block to ``q``'s dtype first (equal in float32). And a
KV chunk that lies wholly past a causal query chunk's last position is
skipped when every query row of the chunk sees key 0: the reference's
iteration over such a chunk adds exact zeros (``exp(-1e30 - m) = 0`` with
``m`` finite), so the result is the same. The kernel tiles by its own
sizes (64 rows and 32 or 64 keys), keeps scores in float32 and adds each
product in float32 across tiles; ``q_chunk``/``kv_chunk`` choose only the
plain version's rounding points.

``attention_dense`` (the fallback for shapes that do not chunk) and decode
attention stay plain PyTorch on both devices, as the reference computes
them with einsums outside any kernel.

``decode_attention`` is the single-token serve path over a KV cache.
Under a mesh the cache's sequence is split over ``model`` (the reference's
cache specs, ``configs.lm_common._cache_specs``): ``write_slot`` writes on
the rank whose block holds the slot, and ``decode_attention_split``
attends over each rank's block and combines the blocks over the axis
(flash-decoding's split-K: the max, the sum and the PV product each
reduced once).
"""

from __future__ import annotations

import torch

from repro_torch.distributed.mesh import pmax, reduce_from
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, dh) -> (B, S, KV*n_rep, dh) for GQA."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, dh) \
        .reshape(b, s, kv * n_rep, dh)


def attention_dense(q, k, v, causal: bool = True, scale: float | None = None):
    """Reference full-materialisation attention. q (B,T,H,dh) k/v (B,S,KV,dh)."""
    b, t, h, dh = q.shape
    s = k.shape[1]
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = scale if scale is not None else dh ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q, k) * scale
    if causal:
        mask = torch.ones((t, s), dtype=torch.bool,
                          device=q.device).tril(diagonal=s - t)
        logits = torch.where(mask[None, None], logits, NEG_INF)
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", w, v)


class FlashAttention(torch.autograd.Function):
    """``ops.flash_attention_fwd`` with its FlashAttention-2 backward
    (``ops.flash_attention_bwd``); saves ``(q, k, v, out, lse)`` and
    nothing per chunk."""

    @staticmethod
    def forward(ctx, q, k, v, q_start, causal, q_chunk, kv_chunk, scale):
        out, lse = ops.flash_attention_fwd(q, k, v, q_start, causal, q_chunk,
                                           kv_chunk, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_start, causal, q_chunk, kv_chunk, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                             *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    scale: float | None = None, q_start: int | None = None):
    """Chunked online-softmax attention; same contract as attention_dense.

    ``q_start`` (int): global position of query row 0 for callers whose q
    block is a sequence shard. When given, the implied k/v positions are
    0..S and causality is evaluated in global coordinates (``q_start``
    defaults to S - T, the standard suffix alignment)."""
    t, dh = q.shape[1], q.shape[3]
    s = k.shape[1]
    q_chunk = min(q_chunk, t)
    kv_chunk = min(kv_chunk, s)
    if t % q_chunk or s % kv_chunk:
        # the reference's semantics: shapes that do not chunk go dense
        if q_start is not None:
            raise ValueError("q_start needs chunkable shapes")
        return attention_dense(q, k, v, causal, scale)
    scale = scale if scale is not None else dh ** -0.5
    if q_start is None:
        q_start = s - t
    return FlashAttention.apply(q, k, v, int(q_start), causal, q_chunk,
                                kv_chunk, scale)


def write_slot(cache: torch.Tensor, new: torch.Tensor, length,
               seq_len: int | None = None, start: int = 0) -> None:
    """Write ``new`` (B, 1, ...) into slot ``length`` of ``cache`` (B, S,
    ...) in place, the slot clamped into ``[0, S - 1]`` as
    ``jax.lax.dynamic_update_slice_in_dim`` clamps its start: a write at or
    past the end lands in the last slot.

    ``cache`` may be the block of slots ``[start, start + S_block)`` of a
    cache of ``seq_len`` slots (its sequence split over ranks): the slot is
    clamped into the whole cache and written only where the block holds
    it."""
    n = cache.shape[1] if seq_len is None else seq_len
    slot = min(max(int(length), 0), n - 1) - start
    if 0 <= slot < cache.shape[1]:
        cache[:, slot:slot + 1] = new.to(cache.dtype)


def split_softmax(logits: torch.Tensor, valid: torch.Tensor, mesh, axis,
                  dtype) -> torch.Tensor:
    """``softmax(where(valid, logits, NEG_INF))`` in float32 over the last
    dim, whose keys are split over ``axis`` (each rank holds its block),
    rounded to ``dtype``: the max and the sum reduced over the axis (on
    one rank, ``decode_attention``'s softmax)."""
    logits = torch.where(valid, logits.float(), NEG_INF)
    if mesh.axis_size(axis) == 1:
        return torch.softmax(logits, dim=-1).to(dtype)
    m = pmax(logits.amax(-1, keepdim=True), mesh, axis)
    p = torch.exp(logits - m)
    return (p / reduce_from(p.sum(-1, keepdim=True), mesh, axis)).to(dtype)


def decode_attention_split(q, k_cache, v_cache, length, mesh,
                           axis: str = "model", scale: float | None = None):
    """``decode_attention`` over a cache whose sequence is split over
    ``axis``: ``k_cache``/``v_cache`` (B, S / n, KV, dh) are this rank's
    block of slots, ``q`` (B, H, dh) every head, ``length`` the valid slots
    of the whole cache. Each rank's PV product over its block is summed
    over the axis; every rank returns the whole (B, H, dh)."""
    b, s, kv, dh = k_cache.shape
    h = q.shape[1]
    n_rep = h // kv
    scale = scale if scale is not None else dh ** -0.5
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    qr = q.reshape(b, kv, n_rep, dh).to(dt)
    logits = torch.einsum("bknd,bskd->bkns", qr, k_cache.to(dt)) * scale
    n_valid = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    pos = mesh.axis_index(axis) * s + torch.arange(s, device=q.device)
    valid = (pos[None, :] < n_valid)[:, None, None, :]
    w = split_softmax(logits, valid, mesh, axis, q.dtype)
    dt = torch.promote_types(w.dtype, v_cache.dtype)
    out = torch.einsum("bkns,bskd->bknd", w.to(dt), v_cache.to(dt))
    return reduce_from(out, mesh, axis).reshape(b, h, dh)


def decode_attention(q, k_cache, v_cache, length, scale: float | None = None):
    """One-token attention over a KV cache.

    q (B, H, dh); caches (B, S, KV, dh); ``length`` = #valid cache slots
    (an int, or a tensor of shape () or (B,)). A cache in another dtype
    than ``q`` is promoted as JAX promotes.
    """
    b, s, kv, dh = k_cache.shape
    h = q.shape[1]
    n_rep = h // kv
    scale = scale if scale is not None else dh ** -0.5
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    qr = q.reshape(b, kv, n_rep, dh).to(dt)
    logits = torch.einsum("bknd,bskd->bkns", qr, k_cache.to(dt)) * scale
    n_valid = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < n_valid
    logits = torch.where(valid[:, None, None, :], logits.float(), NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = torch.promote_types(w.dtype, v_cache.dtype)
    out = torch.einsum("bkns,bskd->bknd", w.to(dt), v_cache.to(dt))
    return out.reshape(b, h, dh)
