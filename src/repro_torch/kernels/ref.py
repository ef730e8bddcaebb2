"""Plain PyTorch versions of the kernels' entries (the allclose targets).

The kernel wrappers run these for tensors on the CPU; ``chip_smoke.py`` holds
each kernel against them on the card.

Both follow the kernels' contracts: sums are taken in float32 (float64 for a
float64 oracle) and returned in the inputs' dtype, a bf16 result rounded
once from its float32 sum; an index out of range is clamped into range
(``embedding.layout.lookup``), where the reference's ``jnp.take`` fills.
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
                             rank_of=None) -> torch.Tensor:
    """Two-tier SLS of every table of a batch: ``tables`` are the stored
    (rank-ordered) tables, each split at its ``hot_sizes`` entry; ``indices``
    (B, n_tables, L) are logical ids translated through ``rank_of[t]`` (the
    paper's hash table), or ranks when ``rank_of`` is None; an id is clamped
    into [0, len(rank_of[t])) and a rank into [0, V_t). Returns
    (B, n_tables, D) in the tables' dtype, every table's bags added in
    float32 in one ``sum_in_order`` (L launches, not n_tables * L). The two
    tiers are the stored table's two slices, so the rows are read from it.
    Where the table wants a gradient the table is widened before the
    gather, so that its gradient adds up in float32 (as the kernel's
    Function's does); otherwise only the gathered rows are widened (a
    dlrm-mlperf table is 10 GB in bf16, 20 GB widened)."""
    if len(hot_sizes) != len(tables):
        raise ValueError("need one hot size per table")
    rows = []
    for t, stored in enumerate(tables):
        idx = indices[:, t, :]
        if rank_of is not None:
            idx = lookup(rank_of[t], idx)
        if torch.is_grad_enabled() and stored.requires_grad:
            rows.append(lookup(_widen(stored), idx))
        else:
            rows.append(_widen(lookup(stored, idx)))
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
