"""Per-request latency / throughput accounting (DESIGN.md §3.4, §5.4, §7.4).

A request's latency is completion minus arrival: queueing delay + batching
delay + device service time of the batch it rode in. Percentiles use the
linear-interpolation definition (``np.percentile`` default) so p50 of an
odd-length sample is the median element exactly.

**Degenerate inputs are NaN-safe, never raising** (DESIGN.md §7.4): a shed
request carries ``NaN`` latency, so a class can legitimately arrive here
all-NaN (everything shed) or empty (class absent from the stream). Both
report ``NaN`` percentiles/mean/max with correct counts — ``NaN`` means
"no served sample to summarise", which downstream plotting distinguishes
from a real 0 µs.

``LatencyReport`` summarises a whole replay with one number per quantile;
that hides *when* the tail happened, which is the entire point of the
live-remap lane (DESIGN.md §5.4): an in-band rewrite shows up as a p99
spike in one time bin followed by a lower steady state, not as a shift of
the aggregate. ``tail_timeseries`` bins completions over the simulated
clock and reports per-bin percentiles so the drift benchmark
(``benchmarks/fig_drift_tail.py``) can show the spike-and-recover shape.

The SLO lane (DESIGN.md §7.4) reports **per class**: the top-level report
covers served requests of every class, and ``per_class`` holds one nested
``LatencyReport`` per priority class with that class's own shed/degrade
counts — overload is only legible class-by-class (the whole point of
shedding is that the aggregate hides who paid).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np


@dataclasses.dataclass
class LatencyReport:
    """Tail-latency + throughput summary for one policy's replay."""

    policy: str
    n_requests: int            # served requests (shed excluded)
    p50_us: float
    p95_us: float
    p99_us: float
    mean_us: float
    max_us: float
    throughput_rps: float      # completed requests / makespan
    mean_batch_size: float
    n_batches: int
    device_busy_frac: float    # mean per-channel-per-device utilisation
    energy_uj: float
    # multi-SSD scale-out (DESIGN.md §6): device count and each device's
    # own mean per-channel utilisation over the *global* makespan — the
    # load-balance diagnostic for a shard plan (an idle device shows up
    # as a low entry, not washed into the mean). Empty for 1-device lanes.
    n_devices: int = 1
    device_busy_fracs: tuple = ()
    # SLO lane accounting (DESIGN.md §7.4). ``n_shed`` are offered-but-
    # never-served requests (offered == n_requests + n_shed + n_failed);
    # ``n_degraded`` were served hot-subset-only. ``per_class`` maps
    # priority class -> nested LatencyReport (empty for non-SLO lanes).
    n_shed: int = 0
    n_degraded: int = 0
    per_class: dict = dataclasses.field(default_factory=dict)
    # fault-injection accounting (DESIGN.md §9.4). ``n_failed`` requests
    # errored out on the device (uncorrectable after the retry ladder, or
    # a dead device) — a *device* outcome, distinct from the *policy*
    # outcome ``n_shed`` even though both carry NaN latency.
    n_failed: int = 0
    n_retries: int = 0
    n_uncorrectable: int = 0
    retry_hist: tuple = ()     # page reads by retry depth (0..max_retries)
    n_hedged: int = 0
    hedge_wins: int = 0
    n_failover: int = 0
    # host-DRAM tier accounting (DESIGN.md §10.4). Access-level counters:
    # ``n_dram_hits`` embedding-row lookups served from host DRAM,
    # ``n_dram_misses`` lookups that went to the device tier (hits +
    # misses == every lookup the stream offered), ``n_dram_fills`` rows
    # admitted (each charged as part of a miss-residue device read).
    # All zero when the lane ran without a cache tier.
    n_dram_hits: int = 0
    n_dram_misses: int = 0
    n_dram_fills: int = 0

    @property
    def n_offered(self) -> int:
        """Requests that entered the lane: served + shed + failed."""
        return self.n_requests + self.n_shed + self.n_failed

    @property
    def shed_frac(self) -> float:
        """Shed share of offered traffic (0.0 for an empty lane).

        Counts only policy sheds — device failures are ``failed_frac``
        (conflating the two hid fault losses inside the shed rate).
        """
        return self.n_shed / self.n_offered if self.n_offered else 0.0

    @property
    def failed_frac(self) -> float:
        """Device-failure share of offered traffic."""
        return self.n_failed / self.n_offered if self.n_offered else 0.0

    @property
    def availability(self) -> float:
        """Served share of offered traffic (1.0 for an empty lane)."""
        return (self.n_requests / self.n_offered if self.n_offered
                else 1.0)

    @property
    def hedge_win_rate(self) -> float:
        """Share of hedged sub-requests the replica answered first."""
        return self.hedge_wins / self.n_hedged if self.n_hedged else 0.0

    @property
    def dram_hit_rate(self) -> float:
        """Share of embedding-row lookups served from the host-DRAM tier
        (0.0 for a lane without one, DESIGN.md §10.4)."""
        n = self.n_dram_hits + self.n_dram_misses
        return self.n_dram_hits / n if n else 0.0

    def row(self) -> str:
        return (f"{self.policy:14s} p50 {self.p50_us / 1e3:9.2f}  "
                f"p95 {self.p95_us / 1e3:9.2f}  "
                f"p99 {self.p99_us / 1e3:9.2f} ms   "
                f"{self.throughput_rps:8.0f} req/s   "
                f"batch {self.mean_batch_size:5.1f}   "
                f"util {self.device_busy_frac:5.1%}")


def percentiles(latencies_us: np.ndarray,
                qs: Sequence[float] = (50.0, 95.0, 99.0)
                ) -> tuple[float, ...]:
    """NaN-safe percentiles over served latencies (DESIGN.md §7.4).

    Non-finite entries (shed requests carry ``NaN``) are dropped before
    the quantile computation; with nothing left — an empty class, or a
    class whose every request was shed — every quantile is ``NaN`` rather
    than raising or reporting a fake 0.
    """
    lat = np.asarray(latencies_us, dtype=np.float64)
    lat = lat[np.isfinite(lat)]
    if lat.size == 0:
        return tuple(float("nan") for _ in qs)
    return tuple(float(np.percentile(lat, q)) for q in qs)


def tail_timeseries(completions_us: np.ndarray, latencies_us: np.ndarray,
                    bin_us: float, t0_us: float | None = None,
                    qs: Sequence[float] = (50.0, 95.0, 99.0)
                    ) -> tuple[np.ndarray, np.ndarray,
                               list[tuple[float, ...]]]:
    """Per-time-bin latency percentiles over a replay (DESIGN.md §5.4).

    Requests are bucketed by *completion* time into bins of ``bin_us``
    starting at ``t0_us`` (default: the first completion). Returns
    ``(bin_starts_us, counts, pcts)`` where ``pcts[i]`` is the tuple of
    ``qs`` percentiles of bin ``i`` (empty bins report zeros). Binning by
    completion attributes a stalled request to the moment its stall
    resolved — which is when the spike is *visible* to clients. Shed
    requests (``NaN`` completion) never complete, so they fall out of the
    timeseries entirely — shed accounting lives on the report.
    """
    comp = np.asarray(completions_us, dtype=np.float64)
    lat = np.asarray(latencies_us, dtype=np.float64)
    served = np.isfinite(comp)
    comp, lat = comp[served], lat[served]
    if comp.size == 0:
        return (np.empty(0), np.empty(0, dtype=np.int64), [])
    if bin_us <= 0:
        raise ValueError("bin_us must be positive")
    t0 = float(comp.min()) if t0_us is None else float(t0_us)
    idx = np.floor((comp - t0) / bin_us).astype(np.int64)
    idx = np.maximum(idx, 0)
    n_bins = int(idx.max()) + 1
    starts = t0 + bin_us * np.arange(n_bins)
    counts = np.bincount(idx, minlength=n_bins)
    pcts = [percentiles(lat[idx == b], qs) if counts[b] else
            tuple(0.0 for _ in qs) for b in range(n_bins)]
    return starts, counts, pcts


def summarize(policy: str, latencies_us: np.ndarray, makespan_us: float,
              batch_sizes: list[int], busy_us: float,
              energy_uj: float = 0.0, *, n_devices: int = 1,
              device_busy_fracs: tuple = (), n_shed: int = 0,
              n_degraded: int = 0, per_class: dict | None = None,
              n_failed: int = 0, n_retries: int = 0,
              n_uncorrectable: int = 0,
              retry_hist: np.ndarray | None = None,
              n_hedged: int = 0, hedge_wins: int = 0,
              n_failover: int = 0, n_dram_hits: int = 0,
              n_dram_misses: int = 0,
              n_dram_fills: int = 0) -> LatencyReport:
    """Build a LatencyReport; NaN latencies (shed or failed requests) are
    excluded from every served-side statistic and counted via ``n_shed``/
    ``n_failed``."""
    lat = np.asarray(latencies_us, dtype=np.float64)
    lat = lat[np.isfinite(lat)]
    p50, p95, p99 = percentiles(lat)
    makespan_us = max(makespan_us, 1e-9)
    return LatencyReport(
        policy=policy,
        n_requests=int(lat.size),
        p50_us=p50, p95_us=p95, p99_us=p99,
        mean_us=float(lat.mean()) if lat.size else float("nan"),
        max_us=float(lat.max()) if lat.size else float("nan"),
        throughput_rps=1e6 * lat.size / makespan_us,
        mean_batch_size=(sum(batch_sizes) / len(batch_sizes)
                         if batch_sizes else 0.0),
        n_batches=len(batch_sizes),
        device_busy_frac=busy_us / makespan_us,
        energy_uj=energy_uj,
        n_devices=n_devices,
        device_busy_fracs=tuple(device_busy_fracs),
        n_shed=int(n_shed),
        n_degraded=int(n_degraded),
        per_class=dict(per_class or {}),
        n_failed=int(n_failed),
        n_retries=int(n_retries),
        n_uncorrectable=int(n_uncorrectable),
        retry_hist=(tuple(int(x) for x in retry_hist)
                    if retry_hist is not None else ()),
        n_hedged=int(n_hedged),
        hedge_wins=int(hedge_wins),
        n_failover=int(n_failover),
        n_dram_hits=int(n_dram_hits),
        n_dram_misses=int(n_dram_misses),
        n_dram_fills=int(n_dram_fills),
    )


def summarize_classes(policy: str, classes: np.ndarray,
                      latencies_us: np.ndarray, makespan_us: float,
                      shed_mask: np.ndarray, degraded_mask: np.ndarray,
                      class_names: Sequence[str],
                      failed_mask: np.ndarray | None = None) -> dict:
    """One nested LatencyReport per priority class (DESIGN.md §7.4).

    ``classes`` holds each request's class index into ``class_names``.
    Every class in ``class_names`` gets an entry — absent or all-shed
    classes report NaN quantiles with exact counts, never raising — so
    benchmark tables stay rectangular across load points.

    ``failed_mask`` (DESIGN.md §9.4) marks device failures so they are
    counted as ``n_failed`` instead of polluting the class's shed count
    (both carry NaN latency; per-class availability needs them apart).
    """
    out = {}
    for ci, name in enumerate(class_names):
        sel = classes == ci
        if failed_mask is not None:
            n_fail = int(failed_mask[sel].sum())
            n_shed = int((shed_mask[sel] & ~failed_mask[sel]).sum())
        else:
            n_fail = 0
            n_shed = int(shed_mask[sel].sum())
        out[name] = summarize(
            f"{policy}/{name}", latencies_us[sel], makespan_us, [], 0.0,
            n_shed=n_shed,
            n_degraded=int(degraded_mask[sel].sum()),
            n_failed=n_fail)
    return out
