"""Frequency-remapped two-tier table layout (the reference's
``repro.embedding.layout`` on torch tensors).

The AF remap stores each table in rank order,

  stored[rank] = logical[perm[rank]]        perm = AccessStats.rank_order()

so the hottest rows form a compact prefix: the first ``hot_size`` rows are
the hot tier of the two-tier SLS kernel, the rest its cold tier. Lookups
translate logical ids through ``rank_of`` (the paper's hash table) and read
the stored table. ``RemapSpec`` is the reference's numpy plan, copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class RemapSpec:
    """Host-side remap plan for one table (built from AccessStats)."""

    perm: np.ndarray        # (V,) rank -> logical row
    rank_of: np.ndarray     # (V,) logical row -> rank (inverse perm)
    hot_size: int           # leading ranks of the hot tier
    n_shards: int = 1       # model-parallel shards (for PD striping)

    @classmethod
    def from_counts(cls, counts: np.ndarray, hot_frac: float = 0.002,
                    n_shards: int = 1, plane_distribute: bool = True,
                    hot_size: int | None = None) -> "RemapSpec":
        v = counts.shape[0]
        order = np.argsort(-counts, kind="stable")
        if hot_size is None:
            hot_size = max(1, int(round(v * hot_frac)))
        if n_shards > 1 and plane_distribute:
            # PD at shard granularity: stride ranks over shards so that each
            # shard's local prefix holds an equal share of hot rows.
            # rank r lands on shard r % n_shards at local rank r // n_shards;
            # stored layout is shard-major: [shard0 rows..., shard1 rows...].
            r = np.arange(v)
            shard = r % n_shards
            local = r // n_shards
            rows_per_shard = -(-v // n_shards)
            pos = shard * rows_per_shard + local
            new_order = np.empty(v, dtype=np.int64)
            new_order[pos[pos < v]] = order[pos < v]
            # tail positions beyond v (uneven split) folded back
            overflow = pos >= v
            if overflow.any():
                free = np.setdiff1d(np.arange(v), pos[~overflow],
                                    assume_unique=False)
                new_order[free] = order[overflow]
            order = new_order
        rank_of = np.empty(v, dtype=np.int64)
        rank_of[order] = np.arange(v)
        return cls(perm=order.astype(np.int64), rank_of=rank_of,
                   hot_size=int(hot_size), n_shards=n_shards)

    @classmethod
    def identity(cls, v: int, hot_size: int = 1) -> "RemapSpec":
        r = np.arange(v, dtype=np.int64)
        return cls(perm=r, rank_of=r.copy(), hot_size=hot_size)


def remap_table(table: torch.Tensor, spec: RemapSpec) -> torch.Tensor:
    """Materialise the stored (rank-ordered) table from the logical one."""
    perm = torch.as_tensor(spec.perm, device=table.device)
    return torch.index_select(table, 0, perm)


def translate(indices: torch.Tensor, spec: RemapSpec) -> torch.Tensor:
    """Logical ids -> stored ranks (the paper's hash-table lookup)."""
    rank_of = torch.as_tensor(spec.rank_of, device=indices.device)
    return lookup(rank_of, indices)


def lookup_remapped(stored: torch.Tensor, rank_of: torch.Tensor,
                    indices: torch.Tensor) -> torch.Tensor:
    """Gather logical ``indices`` from a rank-ordered stored table."""
    return lookup(stored, lookup(rank_of, indices))


def lookup(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table[indices]`` along axis 0 for int32 or int64 ``indices`` of any
    shape, each index first clamped into ``[0, len(table))``
    (``jnp.take(table, indices, axis=0, mode="clip")``).

    The clamp is the port's one contract for indices out of range, the CUDA
    SLS kernel's too: an id below 0 reads row 0, an id at or past the end
    the last row. The reference's ``jnp.take`` fills instead (its default
    mode): -1 reads the last row there and an id at or past the end gives
    NaN.
    """
    idx = indices.reshape(-1).clamp(0, table.shape[0] - 1)
    flat = torch.index_select(table, 0, idx)
    return flat.reshape(*indices.shape, *table.shape[1:])
