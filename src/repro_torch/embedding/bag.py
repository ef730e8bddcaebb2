"""EmbeddingBag over fixed ``(batch, bag)`` index matrices, the DLRM
multi-hot case (the reference's ``embedding_bag_dense``): a gather and a
plain reduction over the bag axis. It is the plain version of the SLS
kernel (``repro_torch.kernels.ref``).
"""

from __future__ import annotations

import torch

from repro_torch.embedding.layout import lookup


def embedding_bag_dense(table: torch.Tensor, indices: torch.Tensor,
                        mode: str = "sum",
                        weights: torch.Tensor | None = None) -> torch.Tensor:
    """Pooled lookup: table (V, D), indices (..., L) -> (..., D)."""
    vecs = lookup(table, indices)                    # (..., L, D)
    if weights is not None:
        vecs = vecs * weights[..., None]
    if mode == "sum":
        return vecs.sum(dim=-2)
    if mode == "mean":
        return vecs.mean(dim=-2)
    if mode == "max":
        return vecs.amax(dim=-2)
    raise ValueError(f"unknown mode {mode!r}")
