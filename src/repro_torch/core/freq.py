"""Access-frequency statistics over embedding-table rows (paper §III-C1).

The remapping pipeline starts by sweeping a *sampled* training set and
counting per-row access frequency for every embedding table. The sorted
order of those counts defines the hash table (logical row -> physical flash
address) built before training, so remapping adds no training/inference-time
overhead.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AccessStats:
    """Per-row access counts for one embedding table."""

    counts: np.ndarray  # (n_rows,) int64

    @property
    def n_rows(self) -> int:
        return int(self.counts.shape[0])

    @classmethod
    def from_trace(cls, indices: np.ndarray, n_rows: int) -> "AccessStats":
        counts = np.bincount(np.asarray(indices).ravel(), minlength=n_rows)
        return cls(counts=counts.astype(np.int64))

    def merge(self, other: "AccessStats") -> "AccessStats":
        return AccessStats(self.counts + other.counts)

    def rank_order(self) -> np.ndarray:
        """Row ids sorted by access count, descending (stable).

        ``rank_order()[i]`` is the logical row occupying hot-rank ``i``.
        """
        # stable sort on negated counts keeps row-id order among ties,
        # matching the deterministic hash-table construction in the paper.
        return np.argsort(-self.counts, kind="stable")

    def hot_threshold(self, top_frac: float) -> int:
        """Access count of the top-``top_frac`` boundary row (paper Fig. 6b)."""
        k = max(1, int(round(self.n_rows * top_frac)))
        order = self.rank_order()
        return int(self.counts[order[k - 1]])

    def unique_access_rate(self) -> float:
        total = int(self.counts.sum())
        if total == 0:
            return 0.0
        return float((self.counts > 0).sum()) / total
