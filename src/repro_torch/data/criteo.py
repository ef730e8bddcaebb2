"""Day-structured synthetic Criteo-TB / Criteo-Kaggle proxies (paper §IV-A).

A numpy copy of the reference's ``repro.data.criteo``: the same seed gives
the same day batches, drift and sampled counts, array for array.

The paper's real-dataset experiments use Criteo Terabyte (24 days, trained on
day0-22, evaluated on day23) and Criteo Kaggle (6 days). Neither dataset is
available offline, so we generate *statistically matched* day streams:

* 13 dense (int) features, 26 categorical fields with heavily skewed
  (Zipf ~1.05-1.2) per-field popularity — the empirically reported shape of
  Criteo categorical frequency (paper Fig. 3: a tiny fraction of vectors
  absorbs most accesses);
* popularity drift across days (rank churn via bounded random rank walks),
  which is what makes the online-training triggers fire;
* per-day sample counts scaled down to simulation size.

These proxies preserve exactly what the storage simulation consumes: the
row-access marginal distribution per table and its day-over-day drift.

The day streams are the *bulk-loop* form of non-stationarity: consumed a
day at a time by ``Deployment.step_day`` (paper Fig. 14 accounting,
DESIGN.md §5.4) with rank churn applied between days via
``advance_day``. The request-level serving lane has its own in-stream
drift scenarios (``serving/workload.py::DriftScenario``, DESIGN.md §5.2)
— use these day streams when reproducing the paper's daily
online-training figures, and the serving scenarios when the question is
tail latency under drifting open-loop arrivals.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.tracegen import zipf_probs


@dataclasses.dataclass
class CriteoSpec:
    name: str
    n_days: int
    n_fields: int = 26
    n_dense: int = 13
    rows_per_field: int = 1_000_000   # paper assumes 1M rows/table
    zipf_alpha: float = 1.1
    drift_frac: float = 0.02          # share of ranks reshuffled per day


CRITEO_TB = CriteoSpec("criteo_tb", n_days=24)
CRITEO_KAGGLE = CriteoSpec("criteo_kaggle", n_days=6, zipf_alpha=1.05,
                           drift_frac=0.04)


class CriteoDayStream:
    """Generates per-day categorical lookup streams with popularity drift."""

    def __init__(self, spec: CriteoSpec, seed: int = 0):
        self.spec = spec
        self.rng = np.random.default_rng(seed)
        self.probs = zipf_probs(spec.rows_per_field, spec.zipf_alpha)
        # rank -> row-id permutation per field; drifts daily
        self.perms = [self.rng.permutation(spec.rows_per_field)
                      for _ in range(spec.n_fields)]

    def _drift(self) -> None:
        """Swap a random drift_frac of hot ranks with random ranks."""
        n = self.spec.rows_per_field
        n_swap = max(1, int(n * self.spec.drift_frac))
        for perm in self.perms:
            # hot ranks churn: new items become popular, old ones retire.
            hot = self.rng.integers(0, max(2, n // 50), size=n_swap)
            other = self.rng.integers(0, n, size=n_swap)
            perm[hot], perm[other] = perm[other].copy(), perm[hot].copy()

    def day_batch(self, day: int, n_samples: int,
                  lookups_per_field: int = 1):
        """(tables, rows, dense) for one day's ``n_samples`` inferences."""
        del day  # popularity state advances via advance_day()
        spec = self.spec
        total = n_samples * spec.n_fields * lookups_per_field
        tables = np.repeat(np.tile(np.arange(spec.n_fields), n_samples),
                           lookups_per_field)
        rows = np.empty(total, dtype=np.int64)
        for f in range(spec.n_fields):
            sel = tables == f
            ranks = self.rng.choice(spec.rows_per_field, size=int(sel.sum()),
                                    p=self.probs)
            rows[sel] = self.perms[f][ranks]
        dense = self.rng.poisson(3.0, size=(n_samples, spec.n_dense)) \
                    .astype(np.float32)
        return tables, rows, dense

    def advance_day(self) -> None:
        self._drift()

    def sample_training_stats(self, n_samples: int, seed: int = 1):
        """Sampled offline training sweep (paper §III-C1): per-field counts."""
        spec = self.spec
        counts = np.zeros((spec.n_fields, spec.rows_per_field), dtype=np.int64)
        rng = np.random.default_rng(seed)
        for f in range(spec.n_fields):
            ranks = rng.choice(spec.rows_per_field, size=n_samples,
                               p=self.probs)
            np.add.at(counts[f], self.perms[f][ranks], 1)
        return counts
