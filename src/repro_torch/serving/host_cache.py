"""Host-DRAM cache tier in front of the device lanes (DESIGN.md §10).

RecFlash's frequency-based remapping maximises page-buffer utilisation
*inside* the device; RecNMP and RecSSD (PAPERS.md) both put a host/near
memory tier *above* it and serve the hottest embedding rows from DRAM.
This module is that tier: a row-granular cache shared by every policy
lane of a deployment (it sits above the device, so its behaviour is
policy-independent), consulted by the replay paths *before* batching and
before the multi-SSD scatter (DESIGN.md §10.1).

**Frequency-informed admission** (§10.1): rather than plain LRU, the
``freq`` policy decides by frequency on both ends of the cache. A miss
whose row's *sampled* offline rank (``AccessStats``, the same stats the
in-device mapping uses) is inside the top ``admit_frac`` of its table is
admitted outright — the admission prior. A row below that rank bypasses
the cache *unless* its **observed** aged window count strictly exceeds
the minimum-count resident's (the admission duel, the TinyLFU rule):
one-hit wonders never displace a counted resident, while a drifted-in
hot row accumulates counts across its misses and wins the duel within a
few reuses. Eviction is always the minimum ``(count, last_used, row)``
resident, and every count is halved each ``age_every`` lookups — hot
rows are pinned by observed traffic and aged out when it moves. The
``lru`` policy admits everything and evicts by recency — the ablation
baseline ``benchmarks/fig_cache_tier.py`` sweeps against.

**Charging semantics** (§10.2): there is no free warmup. A row becomes
resident only through a *miss* that is dispatched to the device — the
fill rides the miss-residue batch, a real batched device read on the
existing channel timeline — so the first touch of any row always pays
NAND latency and only later touches hit. Cache state advances in stream
(arrival, rid) order at lookup time; hits within a request are judged
against residency at its arrival (an intra-request duplicate miss does
not hit its own fill). Evictions are clean drops (embedding rows are
read-only at serving time): they cost no device traffic but are counted
in ``evict_bytes`` so fills/evictions/residency reconcile exactly
(property-tested in ``tests/test_host_cache.py``).

**Multi-model sharing** (§10.3): one ``HostCache`` instance can back
several deployments. Each registers with its own ``HostCacheConfig``
whose ``quota`` is its fraction of the shared ``dram_bytes``; quotas are
static admission budgets (they must sum to <= 1), so one model's
admissions can never evict another model's residents.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.engine import TableSpec
from repro_torch.core.freq import AccessStats
from repro_torch.serving.workload import Request

ADMISSION_POLICIES = ("freq", "lru")


@dataclasses.dataclass(frozen=True)
class HostCacheConfig:
    """Host-DRAM tier knobs for one model (DESIGN.md §10.1); JSON-flat.

    ``dram_bytes`` is the *shared* tier capacity (every model registering
    on one tier must agree on it); ``quota`` is this model's fraction of
    it. ``admit_frac`` applies to the ``freq`` policy only: the top
    fraction of each table's sampled-frequency ranks admitted without an
    observed-count duel. ``t_dram_us`` + ``n_hits * t_dram_per_vec_us``
    is the DRAM service time of a request's hit portion; ``age_every``
    is the lookup period at which observed window counts are halved
    (0 = never age).
    """

    dram_bytes: int = 4 << 20
    policy: str = "freq"            # "freq" | "lru"
    admit_frac: float = 0.25
    t_dram_us: float = 2.0
    t_dram_per_vec_us: float = 0.01
    age_every: int = 4096
    quota: float = 1.0

    def __post_init__(self) -> None:
        if self.dram_bytes < 1:
            raise ValueError("dram_bytes must be positive")
        if self.policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {self.policy!r}; "
                             f"have {ADMISSION_POLICIES}")
        if not 0.0 < self.admit_frac <= 1.0:
            raise ValueError("admit_frac must be in (0, 1]")
        if self.t_dram_us < 0 or self.t_dram_per_vec_us < 0:
            raise ValueError("DRAM service times must be >= 0")
        if self.age_every < 0:
            raise ValueError("age_every must be >= 0")
        if not 0.0 < self.quota <= 1.0:
            raise ValueError("quota must be in (0, 1]")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HostCacheConfig":
        return cls(**d)


class HostCacheBinding:
    """One model's handle on a (possibly shared) :class:`HostCache`.

    Holds the model-local admission data — flat row offsets, per-row
    vector sizes, the sampled-frequency prior mask, the observed window
    counts — and the model's resident set. Quotas statically partition
    the shared budget
    (DESIGN.md §10.3), so per-model state is independent by construction;
    the shared ``HostCache`` validates that the partitions fit.
    """

    def __init__(self, cache: "HostCache", model_id: int,
                 cfg: HostCacheConfig, tables: list[TableSpec],
                 stats: list[AccessStats]) -> None:
        self.cache = cache
        self.model_id = model_id
        self.cfg = cfg
        self.quota_bytes = int(cfg.quota * cache.dram_bytes)
        self._row_offset = np.zeros(len(tables) + 1, dtype=np.int64)
        np.cumsum([t.n_rows for t in tables], out=self._row_offset[1:])
        flat_n = int(self._row_offset[-1])
        self._vec = np.concatenate(
            [np.full(t.n_rows, t.vec_bytes, dtype=np.int64)
             for t in tables])
        if cfg.policy == "freq":
            self._admissible = np.zeros(flat_n, dtype=bool)
            for t, (spec, st) in enumerate(zip(tables, stats, strict=True)):
                n_adm = max(1, int(cfg.admit_frac * spec.n_rows))
                rank = st.rank_order()
                self._admissible[self._row_offset[t] + rank[:n_adm]] = True
        else:
            self._admissible = np.ones(flat_n, dtype=bool)
        # test instrumentation (DESIGN.md §10.1 monotonicity property):
        # when on, every eviction logs (victim row, victim count, max
        # count among the remaining residents). O(residents) per
        # eviction — leave off outside tests.
        self.track_evictions = False
        self.eviction_log: list[tuple[int, int, int]] = []
        self._reset()

    # -- state ---------------------------------------------------------------
    def _reset(self) -> None:
        flat_n = self._vec.size
        self._resident = np.zeros(flat_n, dtype=bool)
        # observed (aged) window count per flat row — the online half of
        # the admission rule. Counts accumulate for *every* accessed row,
        # resident or not: that is what lets a drifted-in hot row build
        # the evidence to win the duel (§10.1).
        self._counts = np.zeros(flat_n, dtype=np.int64)
        self._last: dict[int, int] = {}     # resident rows only
        self._heap: list[tuple] = []        # lazy-deletion victim heap
        self._tick = 0
        self.resident_bytes = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_fills = 0
        self.fill_bytes = 0
        self.evict_bytes = 0

    def begin_stream(self) -> None:
        """Cold-start this model's tier state and counters for one replay
        (each policy lane of a ``run_stream`` sees the same cold cache;
        other models' residents on a shared tier are untouched)."""
        self._reset()

    def residents(self) -> np.ndarray:
        """Resident flat row ids, ascending."""
        return np.flatnonzero(self._resident)

    # -- the admission/eviction machinery ------------------------------------
    def _key(self, f: int) -> tuple:
        if self.cfg.policy == "freq":
            return (int(self._counts[f]), self._last[f], f)
        return (self._last[f], f)

    def _touch(self, f: int) -> None:
        self._last[f] = self._tick
        heapq.heappush(self._heap, self._key(f))

    def _age(self) -> None:
        """Halve every observed window count (freq only) — stale-hot
        rows lose their pin as traffic moves (§10.1)."""
        self._counts //= 2
        self._heap = [self._key(f) for f in self._last]
        heapq.heapify(self._heap)

    def _victim(self) -> int | None:
        """Current eviction victim: the heap top after lazy cleanup."""
        while self._heap:
            k = self._heap[0]
            f = int(k[-1])
            if self._resident[f] and self._key(f) == k:
                return f
            heapq.heappop(self._heap)
        return None

    def _evict_one(self) -> bool:
        f = self._victim()
        if f is None:
            return False
        heapq.heappop(self._heap)
        if self.track_evictions:
            rest = self.residents()
            others = self._counts[rest[rest != f]]
            self.eviction_log.append(
                (f, int(self._counts[f]),
                 int(others.max()) if others.size else -1))
        self._resident[f] = False
        del self._last[f]
        vec = int(self._vec[f])
        self.resident_bytes -= vec
        self.evict_bytes += vec
        return True

    def _maybe_admit(self, f: int) -> None:
        vec = int(self._vec[f])
        if vec > self.quota_bytes:
            return
        if self.resident_bytes + vec <= self.quota_bytes:
            # free capacity admits anything: a cold row that never
            # recurs is the first victim once the quota binds
            self._insert(f, vec)
            return
        if not self._admissible[f]:
            # below the sampled-rank prior: the admission duel (§10.1) —
            # only observed evidence strictly beating the would-be
            # victim's count displaces a resident
            v = self._victim()
            if v is None or self._counts[f] <= self._counts[v]:
                return
        while self.resident_bytes + vec > self.quota_bytes:
            if not self._evict_one():
                return
        self._insert(f, vec)

    def _insert(self, f: int, vec: int) -> None:
        self._resident[f] = True
        self._last[f] = self._tick
        heapq.heappush(self._heap, self._key(f))
        self.resident_bytes += vec
        self.n_fills += 1
        self.fill_bytes += vec

    def lookup(self, tables: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Serve one request's accesses against the tier.

        Returns the per-access hit mask, judged against residency at the
        request's arrival (state updates apply *after* the mask, in
        access order — an intra-request duplicate miss does not hit its
        own fill, DESIGN.md §10.2). Every access bumps its row's
        observed window count; misses then run the admission rule
        (evicting by the policy's victim order), hits and intra-request
        refills touch the resident's recency.
        """
        flat = self._row_offset[np.asarray(tables, dtype=np.int64)] \
            + np.asarray(rows, dtype=np.int64)
        hits = self._resident[flat].copy()
        self.n_hits += int(hits.sum())
        self.n_misses += int(hits.size - hits.sum())
        age_every = self.cfg.age_every if self.cfg.policy == "freq" else 0
        for f in flat.tolist():
            self._tick += 1
            if age_every and self._tick % age_every == 0:
                self._age()
            self._counts[f] += 1
            if self._resident[f]:
                self._touch(f)
            else:
                self._maybe_admit(f)
        return hits


class HostCache:
    """The shared host-DRAM tier: one capacity, N registered models."""

    def __init__(self, dram_bytes: int) -> None:
        if dram_bytes < 1:
            raise ValueError("dram_bytes must be positive")
        self.dram_bytes = int(dram_bytes)
        self.bindings: list[HostCacheBinding] = []

    def register(self, cfg: HostCacheConfig, tables: list[TableSpec],
                 stats: list[AccessStats]) -> HostCacheBinding:
        """Register one model; returns its binding (DESIGN.md §10.3)."""
        if cfg.dram_bytes != self.dram_bytes:
            raise ValueError(
                f"model expects a {cfg.dram_bytes}-byte tier but the "
                f"shared tier has {self.dram_bytes}; every model on one "
                "tier must agree on dram_bytes")
        taken = sum(b.cfg.quota for b in self.bindings)
        if taken + cfg.quota > 1.0 + 1e-9:
            raise ValueError(
                f"admission quotas exceed the tier: {taken:.3f} already "
                f"granted, {cfg.quota:.3f} requested")
        b = HostCacheBinding(self, len(self.bindings), cfg, tables, stats)
        self.bindings.append(b)
        return b

    def resident_bytes(self) -> int:
        """Total bytes resident across every registered model."""
        return sum(b.resident_bytes for b in self.bindings)


@dataclasses.dataclass
class CacheStreamResult:
    """Outcome of short-circuiting one stream through the tier."""

    device_requests: list[Request]  # miss residues, stream order
    device_pos: np.ndarray          # input position of each residue
    dram_served: np.ndarray         # (n,) bool: fully served from DRAM
    hit_counts: np.ndarray          # (n,) int64 accesses served from DRAM
    dram_done_us: np.ndarray        # (n,) DRAM-side completion barrier
    n_hits: int = 0                 # access-level counters, whole stream
    n_misses: int = 0
    n_fills: int = 0
    fill_bytes: int = 0
    evict_bytes: int = 0


def short_circuit(binding: HostCacheBinding,
                  requests: list[Request]) -> CacheStreamResult:
    """Split a stream into DRAM-served hits and device-bound residues.

    Walks the stream in replay order — ``(arrival, rid)``, the same
    lexsort every replay path uses — so tier state advances exactly as
    the lane would observe it (DESIGN.md §10.2). A request whose every
    access hits completes at DRAM latency and never reaches a device; a
    partial hit dispatches only its miss residue (the fill for admitted
    misses rides that residue's batched device read). The binding is
    cold-started first: each replay sees the tier from empty.
    """
    binding.begin_stream()
    n = len(requests)
    cfg = binding.cfg
    rids = np.fromiter((r.rid for r in requests), dtype=np.int64, count=n)
    arr_in = np.fromiter((r.arrival_us for r in requests),
                         dtype=np.float64, count=n)
    order = np.lexsort((rids, arr_in))
    dram_served = np.zeros(n, dtype=bool)
    hit_counts = np.zeros(n, dtype=np.int64)
    dram_done = arr_in.copy()
    device_requests: list[Request] = []
    device_pos: list[int] = []
    for i in order.tolist():
        r = requests[i]
        hits = binding.lookup(r.tables, r.rows)
        h = int(hits.sum())
        hit_counts[i] = h
        if h:
            dram_done[i] = (r.arrival_us + cfg.t_dram_us
                            + h * cfg.t_dram_per_vec_us)
        if h == hits.size and hits.size:
            dram_served[i] = True
        else:
            miss = ~hits
            device_requests.append(r.subset(r.tables[miss], r.rows[miss]))
            device_pos.append(i)
    return CacheStreamResult(
        device_requests=device_requests,
        device_pos=np.asarray(device_pos, dtype=np.int64),
        dram_served=dram_served, hit_counts=hit_counts,
        dram_done_us=dram_done,
        n_hits=binding.n_hits, n_misses=binding.n_misses,
        n_fills=binding.n_fills, fill_bytes=binding.fill_bytes,
        evict_bytes=binding.evict_bytes)
