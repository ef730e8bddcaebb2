"""Plain PyTorch versions of the two kernels (the allclose targets).

The kernel wrappers run these for tensors on the CPU; ``chip_smoke.py`` holds
each kernel against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.embedding.bag import embedding_bag_dense


def recflash_sls_ref(hot: torch.Tensor, cold: torch.Tensor,
                     indices: torch.Tensor) -> torch.Tensor:
    """Two-tier SLS: ``hot`` (H, D) and ``cold`` (V-H, D) are the two tiers
    of the rank-ordered table, ``indices`` (B, L) ranks into the conceptual
    concatenation [hot; cold]. Returns (B, D) bag sums in float32 (rows are
    widened before the sum, as the reference oracle does)."""
    table = torch.cat([hot, cold]).float()
    return embedding_bag_dense(table, indices)


def dot_interaction_ref(z: torch.Tensor) -> torch.Tensor:
    """DLRM pairwise dots: z (B, T, D) -> (B, T, T) float32 Gram matrices."""
    zf = z.float()
    return torch.einsum("bid,bjd->bij", zf, zf)
