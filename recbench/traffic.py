"""The one traffic generator: arrival schedules and Zipf ids, from which a
cell's model module (``models/<module>.py``, ``Model.make_pool``) makes the
seeded pool its traffic file describes.

Frozen copies, so that a change to the program cannot move the yardstick:
``poisson_arrivals`` from ``repro_torch.serving.workload``;
``K_UNIQUE_RATE`` and the calibration of a Zipf exponent to a unique-access
rate from ``repro_torch.data.tracegen`` (``calibrate_alpha``,
``_expected_unique_rate``), rewritten in torch. Ids are drawn on the device
by inverse CDF, each table's popularity order scattered over its ids by a
seeded random permutation, so that the remap has real work to do.
"""

from __future__ import annotations

import numpy as np
import torch

from recbench.synth import derive

# locality knob K -> target unique-access rate (paper §IV-A, via RecSSD)
K_UNIQUE_RATE = {0.0: 0.08, 0.3: 0.22, 0.8: 0.37, 1.0: 0.51, 2.0: 0.66}


def poisson_arrivals(n: int, rate_rps: float, seed: int = 0) -> np.ndarray:
    """``n`` sorted arrival timestamps (us) at ``rate_rps`` requests/sec."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    rng = np.random.default_rng(seed)
    gaps_us = rng.exponential(1e6 / rate_rps, size=n)
    return np.cumsum(gaps_us)


def arrivals_s(traffic: dict, n: int, seed: int) -> np.ndarray:
    """The first ``n`` Poisson arrival times, in seconds, of ``traffic``'s
    rate for run ``seed``."""
    return poisson_arrivals(n, float(traffic["rate_rps"]),
                            derive(seed, "arrivals")) * 1e-6


def zipf_cdf(n_rows: int, alpha: float, device) -> torch.Tensor:
    """The float64 CDF over ranks 1..n_rows of Zipf(alpha)."""
    w = torch.arange(1, n_rows + 1, dtype=torch.float64,
                     device=device).pow_(-alpha)
    cdf = torch.cumsum(w, 0)
    return cdf.div_(cdf[-1].clone())


def expected_unique_rate(n_rows: int, alpha: float, n_draws: int) -> float:
    """E[#unique rows] / n_draws for ``n_draws`` iid Zipf(alpha) draws."""
    w = torch.arange(1, n_rows + 1, dtype=torch.float64).pow_(-alpha)
    p = w / w.sum()
    return float((1.0 - torch.exp(-n_draws * p)).sum()) / n_draws


def calibrate_alpha(n_rows: int, n_draws: int, target_rate: float) -> float:
    """The Zipf exponent whose ``n_draws`` draws over ``n_rows`` rows are
    ``target_rate`` unique, by 40 bisection steps over [0, 3]."""
    lo, hi = 0.0, 3.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if expected_unique_rate(n_rows, mid, n_draws) > target_rate:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _draw(cdf: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=cdf.device, dtype=torch.float64)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)


def zipf_ids(rows: int, alpha: float, n: int, n_prof: int,
             gen: torch.Generator, prof_gen: torch.Generator):
    """``n`` int64 ids over ``rows`` rows, Zipf(``alpha``) by popularity
    rank, each rank scattered to an id by a random permutation drawn from
    ``gen``, which then draws the ids; and ``n_prof`` more from
    ``prof_gen`` over the same permutation, to profile the table. On
    ``gen``'s device."""
    device = gen.device
    perm = torch.randperm(rows, generator=gen, device=device)
    cdf = zipf_cdf(rows, alpha, device)
    return perm[_draw(cdf, n, gen)], perm[_draw(cdf, n_prof, prof_gen)]
