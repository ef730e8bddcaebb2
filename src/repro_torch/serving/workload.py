"""Request-stream modeling for the serving subsystem (DESIGN.md §3.1, §5.2).

A ``Request`` is one recommendation inference: an SLS command of
``n_tables x lookups_per_table`` embedding accesses plus its arrival
timestamp. Arrival processes generate the timestamp stream:

* ``poisson_arrivals`` — memoryless open-loop traffic at a fixed mean rate
  (the classical serving assumption; RecNMP/RecSSD evaluate under it);
* ``bursty_arrivals`` — a two-state Markov-modulated Poisson process
  (on/off): quiet periods at ``rate`` punctuated by bursts at
  ``burst_factor x rate``. This is the irregular, high-volume stream the
  paper's latency claim is about — tail latency separates the policies far
  more than the mean does;
* ``diurnal_arrivals`` — an inhomogeneous Poisson process whose rate swings
  sinusoidally around the mean (day/night traffic modulation).

Drifting streams (``DriftScenario`` + ``make_drifting_requests``) make the
*popularity* side non-stationary too — the condition the paper's online
adaptive remap (Algorithm 1) exists for. A stationary stream never fires
the threshold trigger; a drifting one must (DESIGN.md §5.2).

All times are microseconds of *simulated* time, matching the flashsim
device model; nothing here sleeps.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

from repro_torch.data.tracegen import generate_sls_batch, popularity_perm


# Priority/SLO classes, highest priority first (DESIGN.md §7.1). The
# order is the scheduler's strict service order: a lane never starts a
# lower class's batch while a higher class has arrived work pending.
SLO_CLASSES = ("latency_critical", "standard", "bulk")


@dataclasses.dataclass
class Request:
    """One inference request: an SLS command plus its arrival time.

    ``slo`` is the request's priority/SLO class (one of ``SLO_CLASSES``);
    the plain replay ignores it, the SLO-aware lane
    (``serving/slo_scheduler.py``) schedules by it. Defaults to
    ``standard`` so pre-SLO streams are unchanged.
    """

    rid: int
    arrival_us: float
    tables: np.ndarray       # (n_lookups,) table id per access
    rows: np.ndarray         # (n_lookups,) row id per access
    slo: str = "standard"    # priority class (SLO_CLASSES)

    @property
    def n_lookups(self) -> int:
        return int(self.rows.size)

    def subset(self, tables: np.ndarray, rows: np.ndarray) -> "Request":
        """The same request carrying a substituted access stream.

        Used by the scatter phase of the multi-SSD dispatch (DESIGN.md
        §6.2): a request fans out into one sub-request per owning device,
        each keeping the parent's ``rid``/arrival/class (the gather
        barrier joins them back on the rid) with the device-local slice
        of the accesses.
        """
        return Request(rid=self.rid, arrival_us=self.arrival_us,
                       tables=tables, rows=rows, slo=self.slo)


def assign_slo_classes(requests: list[Request],
                       mix: Sequence[float] | np.ndarray,
                       seed: int = 0) -> list[Request]:
    """Annotate a stream with priority classes drawn i.i.d. from ``mix``.

    ``mix`` is the ``(latency_critical, standard, bulk)`` probability
    tuple (normalised here, so any non-negative weights work). Requests
    are mutated in place (class is an annotation, not a new stream) and
    the list is returned for chaining. The draw is seeded and *positional*
    — request ``i``'s class depends only on ``(seed, i)``, never on
    arrival times or access contents — so the same stream re-annotated
    with the same seed is identical, and drift scenarios compose
    orthogonally (DESIGN.md §7.1).
    """
    p = np.asarray(mix, dtype=np.float64)
    if p.size != len(SLO_CLASSES) or np.any(p < 0) or p.sum() <= 0:
        raise ValueError(f"mix must be {len(SLO_CLASSES)} non-negative "
                         "weights with a positive sum")
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(SLO_CLASSES), size=len(requests), p=p / p.sum())
    for r, i in zip(requests, idx.tolist(), strict=True):
        r.slo = SLO_CLASSES[i]
    return requests


def poisson_arrivals(n: int, rate_rps: float, seed: int = 0) -> np.ndarray:
    """``n`` sorted arrival timestamps (us) at ``rate_rps`` requests/sec."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    rng = np.random.default_rng(seed)
    gaps_us = rng.exponential(1e6 / rate_rps, size=n)
    return np.cumsum(gaps_us)


def bursty_arrivals(n: int, rate_rps: float, burst_factor: float = 8.0,
                    burst_len: int = 32, duty: float = 0.25,
                    seed: int = 0) -> np.ndarray:
    """On/off modulated arrivals: bursts of ``burst_len`` requests arrive at
    ``burst_factor x rate_rps``; between bursts the stream idles so the
    long-run mean rate stays ``rate_rps``. ``duty`` is the expected
    fraction of requests that belong to bursts."""
    if not 0.0 < duty <= 1.0:
        raise ValueError("duty must be in (0, 1]")
    rng = np.random.default_rng(seed)
    gaps_us = rng.exponential(1e6 / rate_rps, size=n)
    # per-step burst-start probability solving
    #   E[burst fraction] = p*burst_len / (p*burst_len + 1-p) = duty
    p_start = duty / (duty + burst_len * (1.0 - duty))
    in_burst = np.zeros(n, dtype=bool)
    i = 0
    while i < n:
        if rng.random() < p_start:
            in_burst[i:i + burst_len] = True
            i += burst_len
        else:
            i += 1
    # bursts compress their gaps; quiet stretches absorb the reclaimed time
    # so the long-run mean rate is conserved. If a (short) stream came out
    # all-burst, rescale every gap instead — same total duration either way.
    total = gaps_us.sum()
    gaps_us[in_burst] /= burst_factor
    quiet = ~in_burst
    if in_burst.any():
        if quiet.any():
            reclaimed = gaps_us[in_burst].sum() * (burst_factor - 1.0)
            gaps_us[quiet] += reclaimed / quiet.sum()
        else:
            gaps_us *= total / gaps_us.sum()
    return np.cumsum(gaps_us)


def diurnal_arrivals(n: int, rate_rps: float, amp: float = 0.6,
                     period_us: float = 2e6, seed: int = 0) -> np.ndarray:
    """Inhomogeneous Poisson arrivals, rate(t) = rate * (1 + amp sin wt).

    Thinning (Lewis-Shedler): candidates at the peak rate
    ``rate * (1 + amp)``, each kept with probability ``rate(t) / peak``.
    The long-run mean rate is ``rate_rps``; ``amp`` in [0, 1) sets how deep
    the trough goes. Rate modulation alone does not move the popularity
    distribution — it stresses the *queue* (peaks saturate a lane that the
    mean rate would not), not the mapping.
    """
    if rate_rps <= 0:
        raise ValueError("rate_rps must be positive")
    if not 0.0 <= amp < 1.0:
        raise ValueError("amp must be in [0, 1)")
    rng = np.random.default_rng(seed)
    peak = rate_rps * (1.0 + amp)
    out = np.empty(n, dtype=np.float64)
    got, t = 0, 0.0
    w = 2.0 * np.pi / period_us
    while got < n:
        gaps = rng.exponential(1e6 / peak, size=max(64, 2 * (n - got)))
        cand = t + np.cumsum(gaps)
        keep = rng.random(cand.size) * (1.0 + amp) \
            < 1.0 + amp * np.sin(w * cand)
        kept = cand[keep]
        take = min(kept.size, n - got)
        out[got:got + take] = kept[:take]
        got += take
        t = float(cand[-1])
    return out


ARRIVAL_PROCESSES = {"poisson": poisson_arrivals, "bursty": bursty_arrivals,
                     "diurnal": diurnal_arrivals}

DRIFT_KINDS = ("none", "gradual", "flash_crowd", "diurnal")


@dataclasses.dataclass(frozen=True)
class DriftScenario:
    """Declarative non-stationarity spec for an open-loop stream (§5.2).

    ``kind``:

    * ``none``        — stationary stream (byte-identical to the plain
                        ``make_requests`` path);
    * ``gradual``     — popularity shift: the ``shift_frac`` hottest rows
                        of each table progressively retire in favour of
                        previously-cold rows, replacement probability
                        ramping linearly from 0 at stream start to 1 at
                        ``ramp_end`` of the stream;
    * ``flash_crowd`` — a block of ``spike_rows`` cold rows becomes hot
                        mid-stream: during the request-index window
                        ``[spike_start, spike_start + spike_len)`` (stream
                        fractions), each access is redirected into the
                        block with probability ``spike_share``;
    * ``diurnal``     — arrival-rate modulation only (``diurnal_arrivals``);
                        the popularity distribution stays stationary.

    Serializable via ``dataclasses.asdict`` (plain scalars only) so
    ``DeploymentConfig`` can carry it through JSON.
    """

    kind: str = "none"
    # gradual
    shift_frac: float = 0.02      # share of the vocab whose popularity moves
    ramp_end: float = 0.5         # stream fraction where the shift completes
    # flash_crowd
    spike_start: float = 0.4
    spike_len: float = 0.3
    spike_share: float = 0.5
    spike_rows: int = 256
    # diurnal
    diurnal_amp: float = 0.6
    diurnal_period_us: float = 2e6
    drift_seed: int = 97          # redirection draws (independent of trace)

    def __post_init__(self) -> None:
        if self.kind not in DRIFT_KINDS:
            raise ValueError(f"unknown drift kind {self.kind!r}; "
                             f"have {DRIFT_KINDS}")
        if not 0.0 < self.ramp_end <= 1.0:
            raise ValueError("ramp_end must be in (0, 1]")
        if not 0.0 <= self.spike_share <= 1.0:
            raise ValueError("spike_share must be in [0, 1]")

    @property
    def moves_rows(self) -> bool:
        """Whether the scenario rewrites row ids (vs arrivals only)."""
        return self.kind in ("gradual", "flash_crowd")


def apply_drift(tables: np.ndarray, rows: np.ndarray, n_requests: int,
                n_rows: int, scenario: DriftScenario,
                pop_seed: int = 12345) -> np.ndarray:
    """Rewrite a flat row stream according to a drift scenario.

    ``tables``/``rows`` are the request-major flat access arrays of
    ``generate_sls_batch``; returns a new rows array (input untouched).
    Hot/cold row identity comes from ``popularity_perm`` — the same
    rank -> row permutation the trace generator used — so "retiring the
    hottest rows" and "promoting the coldest block" are exact, not
    estimated from counts.
    """
    rows = rows.copy()
    if not scenario.moves_rows:
        return rows
    total = rows.size
    per = total // max(1, n_requests)
    req_idx = np.arange(total) // max(1, per)
    rng = np.random.default_rng(scenario.drift_seed)
    u = rng.random(total)
    for t in np.unique(tables):
        perm = popularity_perm(n_rows, pop_seed, int(t))
        sel = tables == t
        if scenario.kind == "gradual":
            n_shift = max(1, int(scenario.shift_frac * n_rows))
            retiring = perm[:n_shift]
            replacement = perm[n_rows - n_shift:]
            succ = np.arange(n_rows, dtype=np.int64)
            succ[retiring] = replacement
            is_retiring = np.zeros(n_rows, dtype=bool)
            is_retiring[retiring] = True
            ramp = np.minimum(
                1.0, req_idx / max(1.0, scenario.ramp_end * n_requests))
            hit = sel & is_retiring[rows] & (u < ramp)
            rows[hit] = succ[rows[hit]]
        else:  # flash_crowd
            block = perm[n_rows - scenario.spike_rows:]
            lo = scenario.spike_start * n_requests
            hi = (scenario.spike_start + scenario.spike_len) * n_requests
            in_spike = (req_idx >= lo) & (req_idx < hi)
            hit = sel & in_spike & (u < scenario.spike_share)
            rows[hit] = block[rng.integers(0, block.size,
                                           size=int(hit.sum()))]
    return rows


def make_drifting_requests(n_requests: int, n_tables: int, n_rows: int,
                           lookups_per_table: int, arrivals_us: np.ndarray,
                           scenario: DriftScenario, k: float = 0.0,
                           seed: int = 0,
                           pop_seed: int = 12345) -> list[Request]:
    """``make_requests`` with a drift scenario applied to the row stream.

    With ``kind='none'`` (or a pure arrival scenario like ``diurnal``) the
    row stream is byte-identical to ``make_requests`` — drift composes on
    top of the base trace rather than replacing its generator.
    """
    if arrivals_us.size != n_requests:
        raise ValueError("need one arrival timestamp per request")
    tb, rows = generate_sls_batch(n_tables, n_rows, lookups_per_table,
                                  n_requests, k=k, seed=seed,
                                  pop_seed=pop_seed)
    rows = apply_drift(tb, rows, n_requests, n_rows, scenario, pop_seed)
    per = n_tables * lookups_per_table
    tb = tb.reshape(n_requests, per)
    rows = rows.reshape(n_requests, per)
    return [Request(rid=i, arrival_us=float(arrivals_us[i]),
                    tables=tb[i], rows=rows[i])
            for i in range(n_requests)]


def make_requests(n_requests: int, n_tables: int, n_rows: int,
                  lookups_per_table: int, arrivals_us: np.ndarray,
                  k: float = 0.0, seed: int = 0,
                  pop_seed: int = 12345) -> list[Request]:
    """Materialise a request stream sharing one popularity distribution.

    The whole stream is drawn in a single vectorised ``generate_sls_batch``
    call (each request = one inference of the batch) and sliced into
    per-request views — no per-request trace generation.
    """
    if arrivals_us.size != n_requests:
        raise ValueError("need one arrival timestamp per request")
    tb, rows = generate_sls_batch(n_tables, n_rows, lookups_per_table,
                                  n_requests, k=k, seed=seed,
                                  pop_seed=pop_seed)
    per = n_tables * lookups_per_table
    tb = tb.reshape(n_requests, per)
    rows = rows.reshape(n_requests, per)
    return [Request(rid=i, arrival_us=float(arrivals_us[i]),
                    tables=tb[i], rows=rows[i])
            for i in range(n_requests)]
