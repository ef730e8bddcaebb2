"""EmbeddingBag on torch tensors (the reference's ``repro.embedding.bag``):
a gather and a reduction.

* ``embedding_bag_dense``: fixed ``(batch, bag)`` index matrices, the DLRM
  multi-hot case; a plain reduction over the bag axis. (The SLS kernel's
  plain version, ``repro_torch.kernels.ref``, adds in lookup order.)
* ``embedding_bag_ragged``: flat indices grouped by segment ids (torch
  EmbeddingBag's flat layout, with ``offsets_to_segment_ids``), reduced
  per segment with the reference's ``jax.ops.segment_*`` results, empty
  segments included: 0 for ``sum`` and ``mean``, -inf for ``max`` (the
  identity of ``segment_max``; ``F.embedding_bag`` gives 0 there).
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


def embedding_bag_ragged(table: torch.Tensor, indices: torch.Tensor,
                         segment_ids: torch.Tensor, num_bags: int,
                         mode: str = "sum",
                         weights: torch.Tensor | None = None) -> torch.Tensor:
    """Ragged pooled lookup: flat ``indices`` grouped by ``segment_ids``.

    ``indices``/``segment_ids`` are (N,); output is (num_bags, D).
    """
    vecs = lookup(table, indices)                    # (N, D)
    if weights is not None:
        vecs = vecs * weights[:, None]
    shape = (num_bags, vecs.shape[1])
    if mode in ("sum", "mean"):
        sums = vecs.new_zeros(shape).index_add_(0, segment_ids, vecs)
        if mode == "sum":
            return sums
        cnt = torch.zeros(num_bags, dtype=torch.float32,
                          device=vecs.device).index_add_(
            0, segment_ids, torch.ones(segment_ids.shape[0],
                                       dtype=torch.float32,
                                       device=vecs.device))
        return sums / torch.clamp_min(cnt, 1.0)[:, None]
    if mode == "max":
        seg = segment_ids.long()[:, None].expand(-1, shape[1])
        return vecs.new_full(shape, -torch.inf).scatter_reduce_(
            0, seg, vecs, "amax")
    raise ValueError(f"unknown mode {mode!r}")


def offsets_to_segment_ids(offsets: torch.Tensor, total: int) -> torch.Tensor:
    """torch-style bag ``offsets`` (B,) -> per-element segment ids (total,)
    int32.

    Repeated offsets (empty bags) each add one, as the reference's
    ``.at[].add`` does; an offset at or past ``total`` (trailing empty
    bags) adds nothing, as the reference's scatter drops it.
    """
    if offsets.shape[0] <= 1:
        return torch.zeros(total, dtype=torch.int32, device=offsets.device)
    starts = torch.clamp_max(offsets[1:].long(), total)
    marks = torch.zeros(total + 1, dtype=torch.int32, device=offsets.device)
    marks.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    return torch.cumsum(marks[:total], 0, dtype=torch.int32)
