"""Plain PyTorch versions of the kernels' entries (the allclose targets).

The kernel wrappers run these for tensors on the CPU; ``chip_smoke.py`` holds
each kernel against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.embedding.bag import embedding_bag_dense
from repro_torch.embedding.layout import lookup


def recflash_sls_ref(hot: torch.Tensor, cold: torch.Tensor,
                     indices: torch.Tensor) -> torch.Tensor:
    """Two-tier SLS: ``hot`` (H, D) and ``cold`` (V-H, D) are the two tiers
    of the rank-ordered table, ``indices`` (B, L) ranks into the conceptual
    concatenation [hot; cold]. Returns (B, D) bag sums in float32 (rows are
    widened before the sum, as the reference oracle does)."""
    table = torch.cat([hot, cold]).float()
    return embedding_bag_dense(table, indices)


def recflash_sls_grouped_ref(tables, hot_sizes, indices: torch.Tensor,
                             rank_of=None) -> torch.Tensor:
    """Two-tier SLS of every table of a batch: ``tables`` are the stored
    (rank-ordered) tables, each split at its ``hot_sizes`` entry; ``indices``
    (B, n_tables, L) are logical ids translated through ``rank_of[t]`` (the
    paper's hash table), or ranks when ``rank_of`` is None. Returns
    (B, n_tables, D) float32."""
    bags = []
    for t, (stored, h) in enumerate(zip(tables, hot_sizes, strict=True)):
        idx = indices[:, t, :]
        if rank_of is not None:
            idx = lookup(rank_of[t], idx)
        bags.append(recflash_sls_ref(stored[:h], stored[h:], idx))
    return torch.stack(bags, dim=1)


def dot_interaction_ref(z: torch.Tensor) -> torch.Tensor:
    """DLRM pairwise dots: z (B, T, D) -> (B, T, T) float32 Gram matrices."""
    zf = z.float()
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
    (B, T-1, D) -> (B, D + T(T-1)/2) float32, ``bottom_out`` followed by the
    strict upper triangle of the Gram of z = [bottom_out; bags]."""
    z = torch.cat([bottom_out[:, None, :], bags], dim=1)
    return torch.cat([bottom_out.float(),
                      upper_triangle(dot_interaction_ref(z))], dim=1)
