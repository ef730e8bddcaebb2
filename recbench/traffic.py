"""The one traffic generator: arrival schedules, Zipf ids and the seeded
pools a cell's traffic file describes.

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


def make_pool(model, traffic: dict, seed: int, device):
    """The pool a cell's timed path cycles through, and the access counts
    that profile its tables.

    Returns ``dense`` (N, B, n_dense) float32 (standard normal),
    ``indices`` (N, B, n_tables, lookups) int32 logical ids and ``counts``,
    one (V,) int64 numpy array per table. The pool holds N entries of B
    samples (a bulk cell's batches; an online cell's requests, B = 1). The
    counts come from a separate sample of ``profile_samples`` samples of
    the same traffic (same popularity permutation, other draws), never
    from the pool. Table ``t``'s ids are drawn over its first
    ``model.id_rows[t]`` rows (the source's vocabulary, where the stored
    table is padded beyond it), so padding rows are never looked up.
    """
    n, b = int(traffic["pool_entries"]), int(traffic["entry_samples"])
    n_prof = int(traffic["profile_samples"])
    alpha = float(traffic["ids"]["alpha"])
    lookups = model.lookups
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "pool"))
    prof_gen = torch.Generator(device=device)
    prof_gen.manual_seed(derive(seed, "profile"))
    dense = torch.randn((n, b, model.n_dense), generator=gen, device=device)
    indices = torch.empty((n, b, model.n_tables, lookups), dtype=torch.int32,
                          device=device)
    counts = []
    for t, (v, rows) in enumerate(zip(model.vocabs, model.id_rows,
                                      strict=True)):
        perm = torch.randperm(rows, generator=gen, device=device)
        cdf = zipf_cdf(rows, alpha, device)
        ranks = _draw(cdf, n * b * lookups, gen)
        indices[:, :, t, :] = perm[ranks].view(n, b, lookups).to(torch.int32)
        prof = perm[_draw(cdf, n_prof * lookups, prof_gen)]
        counts.append(torch.bincount(prof, minlength=v).cpu().numpy())
        del perm, cdf, ranks, prof
    return dense, indices, counts
