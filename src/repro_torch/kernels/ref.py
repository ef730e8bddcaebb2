"""Plain PyTorch versions of the kernels' entries (the allclose targets).

The kernel wrappers run these for tensors on the CPU (and on meta tensors,
which the dry-run counts); ``chip_smoke.py`` holds each kernel against them
on the card.

The SLS and the interaction follow their kernels' contracts: sums are taken
in float32 (float64 for a float64 oracle) and returned in the inputs'
dtype, a bf16 result rounded once from its float32 sum; an index out of
range is clamped into range (``embedding.layout.lookup``), where the
reference's ``jnp.take`` fills.

``flash_attention_fwd_ref`` and ``flash_attention_bwd_ref`` are the
reference's chunked attention and its FlashAttention-2 backward
(``repro.models.attention``'s ``_flash_fwd`` / ``_flash_bwd``) written
eagerly; ``models.attention`` documents their semantics.
"""

from __future__ import annotations

import torch

from repro_torch.embedding.layout import lookup


def _widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 where it is float64 (a float64
    oracle runs through the plain versions)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def sum_in_order(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` (..., L, D) summed over L one row at a time, in lookup
    order: the additions of the TPU kernel's ``fori_loop`` and of the CUDA
    kernel, so that the plain version rounds each bag as they do. (A
    ``torch.sum`` rounds in another order; a training step's gradients
    through the two forwards can then differ far beyond their rounding
    where a ReLU sits at its kink and a batch sum cancels.)"""
    acc = rows.new_zeros(rows.shape[:-2] + rows.shape[-1:])
    for row in rows.unbind(-2):
        acc = acc + row
    return acc


def recflash_sls_ref(hot: torch.Tensor, cold: torch.Tensor,
                     indices: torch.Tensor) -> torch.Tensor:
    """Two-tier SLS: ``hot`` (H, D) and ``cold`` (V-H, D) are the two tiers
    of the rank-ordered table, ``indices`` (B, L) ranks into the conceptual
    concatenation [hot; cold], each clamped into [0, V). Returns (B, D) bag
    sums in the tables' dtype: rows are widened to float32 before the sum,
    as the reference oracle does, added in lookup order (``sum_in_order``)
    and rounded to the tables' dtype once."""
    table = _widen(torch.cat([hot, cold]))
    return sum_in_order(lookup(table, indices)).to(hot.dtype)


def recflash_sls_grouped_ref(tables, hot_sizes, indices: torch.Tensor,
                             rank_of=None, lookups=None) -> torch.Tensor:
    """Two-tier SLS of every table of a batch: ``tables`` are the stored
    (rank-ordered) tables, each split at its ``hot_sizes`` entry; ``indices``
    (B, n_tables, L) are logical ids translated through ``rank_of[t]`` (the
    paper's hash table), or ranks when ``rank_of`` is None; an id is clamped
    into [0, len(rank_of[t])) and a rank into [0, V_t). With ``lookups``,
    one bag length a table, the indices are ragged: (B, sum(lookups)), table
    t's ids in columns ``[off_t, off_t + lookups[t])``, ``off_t`` the sum of
    the lengths before it. Returns (B, n_tables, D) in the tables' dtype.
    Uniform bags are added in float32 in one ``sum_in_order`` over every
    table (L launches, not n_tables * L); ragged bags in one
    ``sum_in_order`` a table. The two tiers are the stored table's two
    slices, so the rows are read from it.
    Where the table wants a gradient the table is widened before the
    gather, so that its gradient adds up in float32 (as the kernel's
    Function's does); otherwise only the gathered rows are widened (a
    dlrm-mlperf table is 10 GB in bf16, 20 GB widened)."""
    if len(hot_sizes) != len(tables):
        raise ValueError("need one hot size per table")
    if lookups is not None and (len(lookups) != len(tables)
                                or indices.shape[1] != sum(lookups)):
        raise ValueError(f"ragged indices {tuple(indices.shape)} do not hold "
                         f"the bags {tuple(lookups)} of {len(tables)} tables")
    cols = (indices.unbind(1) if lookups is None
            else indices.split(tuple(lookups), dim=1))
    rows = []
    for t, (stored, idx) in enumerate(zip(tables, cols, strict=True)):
        if rank_of is not None:
            idx = lookup(rank_of[t], idx)
        if torch.is_grad_enabled() and stored.requires_grad:
            rows.append(lookup(_widen(stored), idx))
        else:
            rows.append(_widen(lookup(stored, idx)))
    if lookups is not None:
        return torch.stack([sum_in_order(r) for r in rows],
                           dim=1).to(tables[0].dtype)
    return sum_in_order(torch.stack(rows, dim=1)).to(tables[0].dtype)


def dot_interaction_ref(z: torch.Tensor) -> torch.Tensor:
    """DLRM pairwise dots: z (B, T, D) -> (B, T, T) float32 Gram matrices."""
    zf = _widen(z)
    return torch.einsum("bid,bjd->bij", zf, zf)


def upper_triangle(gram: torch.Tensor) -> torch.Tensor:
    """(B, T, T) -> (B, T*(T-1)/2): the strict upper triangle in row-major
    pair order (numpy's ``triu_indices(t, k=1)``)."""
    t = gram.shape[1]
    iu, ju = torch.triu_indices(t, t, 1, device=gram.device)
    return gram[:, iu, ju]


def dot_interaction_fused_ref(bottom_out: torch.Tensor,
                              bags: torch.Tensor) -> torch.Tensor:
    """The top-MLP input of the dot interaction: bottom_out (B, D) and bags
    (B, T-1, D) -> (B, D + T(T-1)/2) in their dtype, ``bottom_out``
    followed by the strict upper triangle of the Gram of z = [bottom_out;
    bags], each dot accumulated in float32."""
    z = torch.cat([bottom_out[:, None, :], bags], dim=1)
    return torch.cat([_widen(bottom_out),
                      upper_triangle(dot_interaction_ref(z))],
                     dim=1).to(bottom_out.dtype)


# -------------------------------------------------------------- attention --
NEG_INF = -1e30


def _grouped(x: torch.Tensor, kv: int) -> torch.Tensor:
    """(B, T, H, d) -> (B, KV, T * n_rep, d), row ``t * n_rep + r`` the
    query head ``kv_head * n_rep + r`` at position ``t``: a chunk of
    positions is a contiguous range of rows, and one KV head's queries are
    one matrix."""
    b, t, h, d = x.shape
    return x.reshape(b, t, kv, h // kv, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, kv, t * (h // kv), d)


def _ungrouped(x: torch.Tensor, t: int, h: int) -> torch.Tensor:
    """Inverse of ``_grouped``: (B, KV, T * n_rep, d) -> (B, T, H, d)."""
    b, kv, _, d = x.shape
    return x.reshape(b, kv, t, h // kv, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, t, h, d)


class _Blocks:
    """The chunking of one call: (GQA-grouped) row ranges and positions of
    each query chunk, KV ranges, and which blocks are masked or skipped."""

    def __init__(self, t, s, n_rep, q_start, causal, q_chunk, kv_chunk,
                 device):
        self.nq, self.nk = t // q_chunk, s // kv_chunk
        self.qc, self.kc, self.n_rep = q_chunk, kv_chunk, n_rep
        self.q_start, self.causal = q_start, causal
        # global position of every grouped row, and of every key
        self.row_pos = (q_start + torch.arange(t, device=device)
                        ).repeat_interleave(n_rep)
        self.k_pos = torch.arange(s, device=device)

    def rows(self, i: int) -> slice:
        r = self.qc * self.n_rep
        return slice(i * r, (i + 1) * r)

    def keys(self, j: int) -> slice:
        return slice(j * self.kc, (j + 1) * self.kc)

    def kv_chunks(self, i: int):
        """``(j, mask or None)`` for the KV chunks query chunk ``i`` reads:
        ``None`` where no key of the block is masked."""
        q_lo = self.q_start + i * self.qc
        q_hi = q_lo + self.qc - 1
        for j in range(self.nk):
            k_lo, k_hi = j * self.kc, (j + 1) * self.kc - 1
            if not self.causal or k_hi <= q_lo:
                yield j, None
            elif k_lo > q_hi and q_lo >= 0:
                return        # this chunk and every later one add zeros
            else:
                yield j, (self.k_pos[self.keys(j)][None, :]
                          <= self.row_pos[self.rows(i)][:, None])


def _scores(qb, kb, mask, scale):
    logits = (qb @ kb.transpose(-1, -2) * scale).float()
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    return logits


def flash_attention_fwd_ref(q, k, v, q_start, causal, q_chunk, kv_chunk,
                            scale):
    """Returns (out (B,T,H,dv), lse (B,KV,T*n_rep) float32)."""
    b, t, h, _ = q.shape
    s, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    blk = _Blocks(t, s, h // kv, q_start, causal, q_chunk, kv_chunk,
                  q.device)
    qg, kg, vg = _grouped(q, kv), _grouped(k, kv), _grouped(v, kv)
    out = torch.empty((b, kv, t * (h // kv), dv), dtype=q.dtype,
                      device=q.device)
    lse = torch.empty((b, kv, t * (h // kv)), dtype=torch.float32,
                      device=q.device)
    for i in range(blk.nq):
        rows = blk.rows(i)
        qb = qg[:, :, rows]
        n = qb.shape[2]
        m = torch.full((b, kv, n), NEG_INF, dtype=torch.float32,
                       device=q.device)
        lsum = torch.zeros((b, kv, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kv, n, dv), dtype=torch.float32,
                          device=q.device)
        for j, mask in blk.kv_chunks(i):
            keys = blk.keys(j)
            logits = _scores(qb, kg[:, :, keys], mask, scale)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            lsum = lsum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + (p.to(q.dtype)
                                            @ vg[:, :, keys]).float()
            m = m_new
        l_safe = lsum.clamp_min(1e-37)
        out[:, :, rows] = (acc / l_safe[..., None]).to(q.dtype)
        lse[:, :, rows] = m + torch.log(l_safe)
    return _ungrouped(out, t, h), lse


def flash_attention_bwd_ref(q, k, v, out, lse, dout, q_start, causal,
                            q_chunk, kv_chunk, scale):
    """FlashAttention-2 backward: recompute p-blocks from the saved lse.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    b, t, h, dh = q.shape
    s, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    blk = _Blocks(t, s, h // kv, q_start, causal, q_chunk, kv_chunk,
                  q.device)
    qg, kg, vg = _grouped(q, kv), _grouped(k, kv), _grouped(v, kv)
    dog = _grouped(dout.to(q.dtype), kv)
    # delta_i = rowsum(dO_i * O_i) in float32
    delta = (dog.float() * _grouped(out, kv).float()).sum(-1)
    dq = torch.empty((b, kv, t * (h // kv), dh), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((b, kv, s, dh), dtype=torch.float32, device=q.device)
    dvg = torch.zeros((b, kv, s, dv), dtype=torch.float32, device=q.device)
    for i in range(blk.nq):
        rows = blk.rows(i)
        qb, dob = qg[:, :, rows], dog[:, :, rows]
        lse_b, d_b = lse[:, :, rows, None], delta[:, :, rows, None]
        dq_b = torch.zeros_like(dq[:, :, rows])
        for j, mask in blk.kv_chunks(i):
            keys = blk.keys(j)
            kb, vb = kg[:, :, keys], vg[:, :, keys]
            p = torch.exp(_scores(qb, kb, mask, scale) - lse_b)
            dvg[:, :, keys] += (p.to(q.dtype).transpose(-1, -2)
                                @ dob).float()
            dp = (dob @ vb.transpose(-1, -2)).float()
            ds = (p * (dp - d_b) * scale).to(q.dtype)
            dq_b += (ds @ kb).float()
            dk[:, :, keys] += (ds.transpose(-1, -2) @ qb).float()
        dq[:, :, rows] = dq_b
    return (_ungrouped(dq, t, h).to(q.dtype),
            _ungrouped(dk, s, kv).to(k.dtype),
            _ungrouped(dvg, s, kv).to(v.dtype))
