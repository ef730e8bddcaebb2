"""Synthetic embedding-access trace generator with a locality knob (paper §IV-A).

The paper (following RecSSD) sweeps a locality parameter
``K in {0, 0.3, 0.8, 1, 2}`` mapping to unique-access rates of 8%..66%
(lower K = higher locality = more reuse). We reproduce that contract
directly: each K targets a unique-access rate and the generator calibrates a
Zipf exponent to hit it for the requested trace length, so the simulator sees
the same reuse structure the paper's traces have.
"""

from __future__ import annotations

import functools

import numpy as np

# K -> target unique-access rate (fraction of accesses that are unique rows),
# interpolated across the paper's stated 8%-66% range.
K_UNIQUE_RATE = {0.0: 0.08, 0.3: 0.22, 0.8: 0.37, 1.0: 0.51, 2.0: 0.66}


def zipf_probs(n_rows: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n_rows + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


def _expected_unique_rate(n_rows: int, alpha: float, n_draws: int) -> float:
    """E[#unique rows] / n_draws for n_draws iid Zipf(alpha) samples."""
    p = zipf_probs(n_rows, alpha)
    exp_unique = float((1.0 - np.exp(-n_draws * p)).sum())
    return exp_unique / n_draws


@functools.lru_cache(maxsize=256)
def calibrate_alpha(n_rows: int, n_draws: int, target_rate: float) -> float:
    """Binary-search the Zipf exponent hitting the target unique rate."""
    lo, hi = 0.0, 3.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        rate = _expected_unique_rate(n_rows, mid, n_draws)
        if rate > target_rate:
            lo = mid          # too uniform -> increase skew
        else:
            hi = mid
    return 0.5 * (lo + hi)


def popularity_perm(n_rows: int, pop_seed: int = 12345,
                    table: int = 0) -> np.ndarray:
    """The rank -> row-id permutation of one table's popularity.

    Single source of the convention shared by ``generate_trace`` /
    ``generate_sls_batch`` (per-table key ``pop_seed + 7919 * table``) and
    by the serving drift scenarios (``serving/workload.py``), which must
    know which logical rows are hot (low rank) to retire them and which
    are cold (high rank) to promote.
    """
    return np.random.default_rng(pop_seed + 7919 * table).permutation(n_rows)


def generate_trace(n_rows: int, n_lookups: int, k: float,
                   seed: int = 0, pop_seed: int = 12345) -> np.ndarray:
    """Row-id trace of ``n_lookups`` accesses with locality ``K``.

    ``pop_seed`` fixes the popularity->row-id permutation. It is a property
    of the *table* (which logical rows are hot), so training-sample stats and
    evaluation traces must share it; ``seed`` varies only the draw. The
    permutation scatters hot rows over random ids so the logical table has no
    rank structure (hot items scattered, Fig. 5a) — this is what makes the
    baseline layout suffer and remapping matter.
    """
    if k not in K_UNIQUE_RATE:
        raise ValueError(f"K={k} not in {sorted(K_UNIQUE_RATE)}")
    rng = np.random.default_rng(seed)
    alpha = calibrate_alpha(n_rows, n_lookups, K_UNIQUE_RATE[k])
    p = zipf_probs(n_rows, alpha)
    ranks = rng.choice(n_rows, size=n_lookups, p=p)
    return popularity_perm(n_rows, pop_seed)[ranks]


def generate_sls_batch(n_tables: int, n_rows: int, lookups_per_table: int,
                       batch_size: int, k: float, seed: int = 0,
                       pop_seed: int = 12345):
    """(tables, rows) arrays for ``batch_size`` inferences of an SLS layer.

    Each inference performs ``lookups_per_table`` lookups in each of
    ``n_tables`` tables (Table II benchmark shapes). Tables draw from
    independent popularity permutations (keyed off ``pop_seed`` + table id,
    stable across train/eval) but share the locality level.
    """
    total = batch_size * n_tables * lookups_per_table
    tables = np.repeat(
        np.tile(np.arange(n_tables), batch_size), lookups_per_table)
    rows = np.empty(total, dtype=np.int64)
    for t in range(n_tables):
        sel = tables == t
        rows[sel] = generate_trace(n_rows, int(sel.sum()), k,
                                   seed=seed * 1009 + t,
                                   pop_seed=pop_seed + 7919 * t)
    return tables, rows
