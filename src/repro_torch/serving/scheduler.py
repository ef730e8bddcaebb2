"""Policy-lane replay over the flashsim device model (DESIGN.md §3.3).

``replay`` runs one request stream through one policy lane. A lane is a
pool of ``n_channels`` concurrent SLS servers — the SSD's NAND channels —
scheduled event-driven over the simulated clock with earliest-free-channel
assignment:

    free[c] = 0 for every channel c
    while queue:
        c        = argmin(free)                           # earliest free
        batch    = batcher.next_batch(queue, free[c])     # dynamic batching
        start    = max(batch.dispatch_us, free[c])
        svc      = sims[c].run(batch).latency_us          # flashsim
        free[c]  = start + svc
        latency[r] = free[c] - r.arrival_us  for r in batch

With ``n_channels=1`` this is exactly the single-server queueing system of
the original design (one coalesced SLS command in service at a time) and
reproduces its numbers bit-for-bit. Per-request latency folds in queueing
delay (backlog), batching delay (max-wait) and device service time — the
serving-level quantity the paper's latency claim is ultimately about.

The hot loop is array-based (DESIGN.md §3.3): the stream's index arrays
are precomputed once (arrival order, concatenated accesses, per-request
offsets), batches are contiguous spans planned by
``DynamicBatcher.next_span``, their access arrays are zero-copy slices,
and latencies/completions are written with one vectorised scatter per
batch — no per-request Python anywhere in replay.

**Live remap** (DESIGN.md §5.3): given a trigger and a
``LiveRemapConfig``, the lane evaluates the trigger *mid-stream* at
window boundaries of the simulated clock. A firing trigger runs the
Algorithm-1 update (``RecFlashEngine.live_remap_step``) and the pages
that actually moved come back as in-band page-program traffic: the work
is split into chunks, distributed round-robin over the channels, and each
chunk rides ahead of that channel's next serving batch — so queued reads
stall behind remap programs (the tail-latency spike) instead of the world
stopping, and the lane converges to the remapped layout's better steady
state.

**Multi-SSD scale-out** (DESIGN.md §6.2): ``replay_sharded`` lifts the
same lane onto N simulated SSDs — scatter each request's accesses to the
devices owning them, run this single-device replay per device, and gather
each request at the max of its device completions (the barrier rule).

The preferred entry point is ``repro_torch.serving.Deployment``; the module-level
``build_policy_engines``/``ServingScheduler`` names are deprecated shims.
"""

from __future__ import annotations

import dataclasses
import heapq
import warnings
from collections import deque
from collections.abc import Callable, Sequence
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.engine import RecFlashEngine, RemapPlan, ShardedEngine
from repro_torch.core.freq import AccessStats
from repro_torch.core.triggers import PeriodTrigger, ThresholdTrigger
from repro_torch.flashsim.device import FlashPart
from repro_torch.flashsim.timeline import SERVING_POLICIES
from repro_torch.serving.batcher import Batch, BatcherConfig, DynamicBatcher
from repro_torch.serving.metrics import LatencyReport, summarize
from repro_torch.serving.workload import Request

if TYPE_CHECKING:  # lazy at runtime (slo_scheduler imports our LaneTrace)
    from repro_torch.serving.host_cache import HostCacheBinding
    from repro_torch.serving.slo_scheduler import SLOConfig


@dataclasses.dataclass(frozen=True)
class LiveRemapConfig:
    """In-band adaptive-remap settings for the replay lane (§5.3).

    ``window_us`` is the online-window length: the trigger is evaluated
    (and the window cleared) every ``window_us`` of simulated time, the
    request-level analogue of ``step_day``'s day boundary. ``chunk_pages``
    bounds how many page programs are issued contiguously: each chunk
    slips in ahead of one serving batch on its channel, so smaller chunks
    spread the rewrite thinner (lower spike, longer to converge) and
    ``chunk_pages >=`` the whole plan degenerates to stop-the-world.
    """

    window_us: float = 250_000.0
    chunk_pages: int = 64

    def __post_init__(self) -> None:
        if self.window_us <= 0:
            raise ValueError("window_us must be positive")
        if self.chunk_pages < 1:
            raise ValueError("chunk_pages must be >= 1")


@dataclasses.dataclass
class RemapEvent:
    """One mid-stream trigger firing and the in-band rewrite it caused."""

    t_fire_us: float               # window boundary the trigger fired at
    plan: RemapPlan                # what physically moved (core/engine.py)
    program_latency_us: float = 0.0  # total channel time the programs took
    energy_uj: float = 0.0
    t_done_us: float = 0.0         # when the last program chunk finished
    n_chunks: int = 0


def _chunk_program_work(plan: RemapPlan, chunk_pages: int
                        ) -> list[tuple[np.ndarray, int]]:
    """Split a plan's page-program traffic into ``(plane_counts, n_blocks)``
    chunks of at most ``chunk_pages`` pages; block erases are spread
    evenly across the chunks. Pages are striped round-robin across planes
    first, so every chunk stays as plane-balanced as the plan allows and
    the multi-plane program overlap ``program_pass`` models is preserved
    (a plane-sorted split would make chunks plane-homogeneous and
    serialise what the device would overlap)."""
    rep = np.repeat(np.arange(plan.plane_counts.size, dtype=np.int64),
                    plan.plane_counts)
    n = rep.size
    # within-plane occurrence rank; ordering by (rank, plane) interleaves
    # the planes: p0,p1,...,p0,p1,... until short planes run dry.
    if n:
        first = np.zeros(plan.plane_counts.size, dtype=np.int64)
        np.cumsum(plan.plane_counts[:-1], out=first[1:])
        rank = np.arange(n, dtype=np.int64) - first[rep]
        plane_of_page = rep[np.lexsort((rep, rank))]
    else:
        plane_of_page = rep
    n_chunks = max(1, -(-n // chunk_pages))
    out = []
    for j in range(n_chunks):
        sl = plane_of_page[j * chunk_pages:(j + 1) * chunk_pages]
        blocks = (plan.n_blocks * (j + 1)) // n_chunks \
            - (plan.n_blocks * j) // n_chunks
        out.append((np.bincount(sl, minlength=plan.plane_counts.size),
                    int(blocks)))
    return out


def build_policy_engines(n_tables: int, n_rows: int, lookups: int,
                         vec_bytes: int, part: FlashPart | str,
                         policies: Sequence[str] = SERVING_POLICIES,
                         k: float = 0.0, seed: int = 0,
                         sample_inferences: int = 512
                         ) -> tuple[dict[str, RecFlashEngine],
                                    list[AccessStats]]:
    """Deprecated: use ``Deployment(DeploymentConfig(...))`` instead.

    Kept as a thin shim over the Deployment offline phase so old callers
    get identical engines. Returns ``(engines, stats)``."""
    warnings.warn(
        "build_policy_engines is deprecated; construct a "
        "repro_torch.serving.Deployment from a DeploymentConfig instead",
        DeprecationWarning, stacklevel=2)
    from repro_torch.core.engine import TableSpec
    from repro_torch.serving.deployment import Deployment, DeploymentConfig
    dep = Deployment(DeploymentConfig(
        tables=[TableSpec(n_rows, vec_bytes)] * n_tables,
        part=getattr(part, "name", part), policies=tuple(policies),
        lookups=lookups, k=k, seed=seed,
        sample_inferences=sample_inferences))
    return dep.engines, dep.stats


@dataclasses.dataclass
class LaneTrace:
    """Full replay record for one policy lane."""

    report: LatencyReport
    batches: list[Batch]
    latencies_us: np.ndarray       # ordered as the input request list
    completions_us: np.ndarray
    # rid -> position in the input request list, built once during replay
    index_of: dict[int, int] = dataclasses.field(default_factory=dict)
    n_channels: int = 1
    batch_channels: np.ndarray | None = None   # channel id per batch
    batch_starts_us: np.ndarray | None = None  # service start per batch
    # mid-stream trigger firings + their in-band rewrites (empty unless
    # replay ran with a trigger and a LiveRemapConfig, DESIGN.md §5.3)
    remap_events: list[RemapEvent] = dataclasses.field(default_factory=list)
    # total channel time consumed (service + in-band programs), summed over
    # channels — the raw quantity behind report.device_busy_frac
    busy_us: float = 0.0
    # multi-SSD scatter-gather replay (DESIGN.md §6.2): device count and
    # the per-device sub-traces the gather was computed from. For a
    # sharded trace, ``batch_channels`` carries *global* channel ids
    # (device d's channels are [d*n_channels, (d+1)*n_channels)).
    n_devices: int = 1
    device_traces: "list[LaneTrace] | None" = None
    # SLO lane extras (DESIGN.md §7; None/empty unless the lane ran under
    # an SLOConfig): per-request class index / shed / degrade arrays in
    # input order, the preempted-batch count, and the decision event log.
    slo_classes: np.ndarray | None = None
    shed_mask: np.ndarray | None = None
    degraded_mask: np.ndarray | None = None
    n_preempted: int = 0
    slo_events: list = dataclasses.field(default_factory=list)
    # fault-injection extras (DESIGN.md §9; None/zero without a FaultConfig):
    # per-request failed flag (uncorrectable read or device failure, input
    # order) and the simulated time the host *detected* each failure (the
    # error return / the device-death instant — failover re-dispatches
    # from here). Distinct from shed: shed is a policy decision, failed is
    # the device erroring out (both are NaN latencies).
    failed_mask: np.ndarray | None = None
    failed_detect_us: np.ndarray | None = None
    n_retries: int = 0
    n_uncorrectable: int = 0
    n_badblock_reads: int = 0
    retry_hist: np.ndarray | None = None
    # replica tier (DESIGN.md §9.2/§9.3): hedge + failover accounting
    n_hedged: int = 0
    hedge_wins: int = 0
    n_failover: int = 0
    replica_traces: "list[LaneTrace] | None" = None
    # host-DRAM tier extras (DESIGN.md §10; None/zero without a cache
    # tier): per-request fully-served-from-DRAM flag and DRAM-hit access
    # count (input order), plus the tier's access/fill/evict counters for
    # the whole stream. ``batches``/``device_traces`` cover only the
    # miss residue the devices actually saw.
    dram_served_mask: np.ndarray | None = None
    dram_hits_per_req: np.ndarray | None = None
    n_dram_hits: int = 0
    n_dram_misses: int = 0
    n_dram_fills: int = 0
    dram_fill_bytes: int = 0
    dram_evict_bytes: int = 0

    def latency_of(self, rid: int, requests: list[Request] | None = None
                   ) -> float:
        """Latency of the request with ``rid`` — O(1) via the stored
        rid->index map (``requests`` is accepted for backward compatibility
        and ignored)."""
        return float(self.latencies_us[self.index_of[rid]])


def _host_cache_replay(requests: list[Request],
                       host_cache: "HostCacheBinding",
                       run_residue: "Callable[[list[Request]], LaneTrace]",
                       *, name: str, n_channels: int,
                       slo: "SLOConfig | None") -> LaneTrace:
    """Short-circuit the host-DRAM tier, then merge (DESIGN.md §10.2).

    The stream is split once by :func:`~repro_torch.serving.host_cache.
    short_circuit` — fully-hit requests complete at DRAM latency and
    never reach a device; partial hits dispatch only their miss residue —
    and ``run_residue`` (the plain / sharded / SLO replay with the tier
    stripped) serves the residue stream on the simulated channel
    timeline, which is where admitted fills get charged. The merged
    trace covers the *full* stream: a partial-hit request completes at
    ``max(device residue completion, DRAM-side completion)`` (the same
    barrier rule as the multi-SSD gather — NaN from a shed or failed
    residue survives it), counters/masks are scattered back to input
    positions, and the report is re-summarised over full-stream
    latencies with the residue trace's device-side accounting.
    """
    n = len(requests)
    index_of = {r.rid: i for i, r in enumerate(requests)}
    if len(index_of) != n:
        raise ValueError("duplicate request rids in stream")
    from repro_torch.serving.host_cache import short_circuit
    sc = short_circuit(host_cache, requests)
    tr = run_residue(sc.device_requests)
    arr_in = np.fromiter((r.arrival_us for r in requests),
                         dtype=np.float64, count=n)
    completions = np.full(n, np.nan, dtype=np.float64)
    completions[sc.dram_served] = sc.dram_done_us[sc.dram_served]
    dev_pos = sc.device_pos
    if dev_pos.size:
        # DRAM-side barrier: the host assembles hit and residue vectors,
        # so a partial hit is done when the slower side is.
        with np.errstate(invalid="ignore"):
            completions[dev_pos] = np.maximum(tr.completions_us,
                                              sc.dram_done_us[dev_pos])
    latencies = completions - arr_in
    first_arrival = float(arr_in.min()) if n else 0.0
    fin = completions[np.isfinite(completions)]
    makespan = (float(fin.max()) - first_arrival) if fin.size else 0.0
    span = max(makespan, 1e-9)

    def _scatter_bool(sub: np.ndarray | None) -> np.ndarray | None:
        if sub is None:
            return None
        out = np.zeros(n, dtype=bool)
        if dev_pos.size:
            out[dev_pos] = sub
        return out

    def _scatter_f64(sub: np.ndarray | None) -> np.ndarray | None:
        if sub is None:
            return None
        out = np.full(n, np.nan, dtype=np.float64)
        if dev_pos.size:
            out[dev_pos] = sub
        return out

    failed_mask = _scatter_bool(tr.failed_mask)
    failed_detect = _scatter_f64(tr.failed_detect_us)
    slo_classes = shed_mask = degraded_mask = None
    per_class: dict = {}
    if slo is not None:
        from repro_torch.serving.metrics import summarize_classes
        from repro_torch.serving.slo_scheduler import SLO_CLASSES
        slo_classes = np.fromiter(
            (SLO_CLASSES.index(r.slo) for r in requests),
            dtype=np.int64, count=n)
        shed_mask = _scatter_bool(tr.shed_mask)
        shed_mask = (shed_mask if shed_mask is not None
                     else np.zeros(n, dtype=bool))
        degraded_mask = _scatter_bool(tr.degraded_mask)
        degraded_mask = (degraded_mask if degraded_mask is not None
                         else np.zeros(n, dtype=bool))
        per_class = summarize_classes(name, slo_classes, latencies,
                                      makespan, shed_mask, degraded_mask,
                                      SLO_CLASSES, failed_mask=failed_mask)
    n_lanes = tr.n_devices + (len(tr.replica_traces)
                              if tr.replica_traces else 0)
    report = summarize(
        name, latencies, makespan, [b.size for b in tr.batches],
        tr.busy_us / (n_lanes * n_channels), tr.report.energy_uj,
        n_devices=tr.n_devices,
        device_busy_fracs=(tuple(d.busy_us / n_channels / span
                                 for d in tr.device_traces)
                           if tr.device_traces else ()),
        n_shed=int(shed_mask.sum()) if shed_mask is not None else 0,
        n_degraded=(int(degraded_mask.sum())
                    if degraded_mask is not None else 0),
        per_class=per_class,
        n_failed=int(failed_mask.sum()) if failed_mask is not None else 0,
        n_retries=tr.n_retries, n_uncorrectable=tr.n_uncorrectable,
        retry_hist=tr.retry_hist, n_hedged=tr.n_hedged,
        hedge_wins=tr.hedge_wins, n_failover=tr.n_failover,
        n_dram_hits=sc.n_hits, n_dram_misses=sc.n_misses,
        n_dram_fills=sc.n_fills)
    return LaneTrace(
        report=report, batches=tr.batches, latencies_us=latencies,
        completions_us=completions, index_of=index_of,
        n_channels=n_channels, batch_channels=tr.batch_channels,
        batch_starts_us=tr.batch_starts_us,
        remap_events=tr.remap_events, busy_us=tr.busy_us,
        n_devices=tr.n_devices, device_traces=tr.device_traces,
        slo_classes=slo_classes, shed_mask=shed_mask,
        degraded_mask=degraded_mask, n_preempted=tr.n_preempted,
        slo_events=tr.slo_events, failed_mask=failed_mask,
        failed_detect_us=failed_detect, n_retries=tr.n_retries,
        n_uncorrectable=tr.n_uncorrectable,
        n_badblock_reads=tr.n_badblock_reads, retry_hist=tr.retry_hist,
        n_hedged=tr.n_hedged, hedge_wins=tr.hedge_wins,
        n_failover=tr.n_failover, replica_traces=tr.replica_traces,
        dram_served_mask=sc.dram_served, dram_hits_per_req=sc.hit_counts,
        n_dram_hits=sc.n_hits, n_dram_misses=sc.n_misses,
        n_dram_fills=sc.n_fills, dram_fill_bytes=sc.fill_bytes,
        dram_evict_bytes=sc.evict_bytes)


def replay(requests: list[Request], engine: RecFlashEngine,
           batcher_cfg: BatcherConfig | None = None,
           record_window: bool = False,
           policy_name: str | None = None,
           n_channels: int = 1,
           trigger: ThresholdTrigger | PeriodTrigger | None = None,
           live: LiveRemapConfig | None = None,
           slo: SLOConfig | None = None,
           host_cache: "HostCacheBinding | None" = None) -> LaneTrace:
    """Run one policy lane over the whole request stream.

    ``n_channels`` is the lane's concurrent-server count (see module
    docstring); each channel gets its own device state via
    ``engine.channel_sims`` (n=1: the engine's own simulator; n>1: private
    planes/buffers and a 1/n slice of the controller P$ SRAM each).

    With both ``trigger`` and ``live`` set (and a remapping policy), the
    lane runs the live-remap loop (module docstring / DESIGN.md §5.3):
    window recording is forced on, the trigger is evaluated at every
    ``live.window_us`` boundary the lane's dispatch clock crosses, and a
    firing trigger's page-program traffic is interleaved chunk-by-chunk
    against the serving batches. Program chunks left over when the stream
    ends are drained after the last batch (their time/energy count toward
    the lane's busy/energy totals, not toward any request's latency).
    With ``trigger`` or ``live`` absent the path is bit-identical to the
    plain replay.

    With ``slo`` (an :class:`~repro_torch.serving.slo_scheduler.SLOConfig`) the
    lane dispatches under the SLO discipline instead — strict priority
    classes, admission, preemption boundaries, shed/degrade ladder
    (DESIGN.md §7). SLO and live remap are separate mid-stream control
    loops and do not compose. With ``slo=None`` this path is untouched.

    With ``host_cache`` (a bound :class:`~repro_torch.serving.host_cache.
    HostCacheBinding`, DESIGN.md §10) the stream is short-circuited
    through the host-DRAM tier first: fully-hit requests complete at
    DRAM latency, only the miss residue enters this lane, and admitted
    fills are charged as part of those residue batches. With
    ``host_cache=None`` every path below is bit-identical to before the
    tier existed (regression-tested in ``tests/test_host_cache.py``).
    """
    if slo is not None:
        if trigger is not None or live is not None:
            raise ValueError("slo scheduling and live remap do not "
                             "compose; configure one mid-stream loop")
        from repro_torch.serving.slo_scheduler import slo_replay
        return slo_replay(requests, engine, slo, batcher_cfg,
                          record_window=record_window,
                          policy_name=policy_name, n_channels=n_channels,
                          host_cache=host_cache)
    if host_cache is not None:
        return _host_cache_replay(
            requests, host_cache,
            lambda sub: replay(sub, engine, batcher_cfg,
                               record_window=record_window,
                               policy_name=policy_name,
                               n_channels=n_channels, trigger=trigger,
                               live=live),
            name=policy_name or engine.policy.name,
            n_channels=n_channels, slo=None)
    batcher = DynamicBatcher(batcher_cfg)
    name = policy_name or engine.policy.name
    n = len(requests)
    live_active = (trigger is not None and live is not None
                   and engine.policy.mapping_mode != "baseline")
    if live_active:
        record_window = True
    remap_events: list[RemapEvent] = []
    # rids need not be dense 0..n-1 (sub-streams, filtered streams) —
    # account positionally against the input list.
    index_of = {r.rid: i for i, r in enumerate(requests)}
    if len(index_of) != n:
        raise ValueError("duplicate request rids in stream")
    latencies = np.zeros(n, dtype=np.float64)
    completions = np.zeros(n, dtype=np.float64)
    batches: list[Batch] = []
    batch_channels: list[int] = []
    batch_starts: list[float] = []
    sims = engine.channel_sims(n_channels)
    for sim in sims:
        sim.reset_state()
    free = np.zeros(n_channels, dtype=np.float64)
    busy = 0.0
    energy = 0.0
    # fault state (DESIGN.md §9.3) — inert (and the loop bit-identical)
    # without an active FaultConfig on the engine
    fault = getattr(engine, "fault", None)
    fault = fault if (fault is not None and fault.active) else None
    stalls = fault.stall_windows() if fault is not None else ()
    t_fail = fault.device_fail_at_us if fault is not None else float("inf")
    failed_mask = np.zeros(n, dtype=bool) if fault is not None else None
    failed_detect = (np.full(n, np.nan) if fault is not None else None)
    n_retries = n_uce = n_bad = 0
    retry_hist: np.ndarray | None = None
    # precompute the whole stream's index arrays once (DESIGN.md §3.3):
    # arrival-sorted order (the RequestQueue contract: (arrival, rid)),
    # one concatenation of every request's accesses, and per-request
    # offsets — each batch is then a contiguous [pos, end) span whose
    # access arrays are zero-copy slices, and latencies/completions are
    # written with one vectorised scatter per batch.
    rids = np.fromiter((r.rid for r in requests), dtype=np.int64, count=n)
    arr_in = np.fromiter((r.arrival_us for r in requests),
                         dtype=np.float64, count=n)
    order = np.lexsort((rids, arr_in))
    reqs = [requests[i] for i in order.tolist()]
    arrivals = arr_in[order]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([r.rows.size for r in reqs], out=offsets[1:])
    tab_all = (np.concatenate([r.tables for r in reqs]) if n
               else np.empty(0, dtype=np.int64))
    row_all = (np.concatenate([r.rows for r in reqs]) if n
               else np.empty(0, dtype=np.int64))
    # live-remap state: the next window boundary on the simulated clock and
    # a per-channel FIFO of pending page-program chunks. Inert (boundary at
    # +inf, empty FIFOs) unless live_active — the plain path is untouched.
    next_boundary = (float(arrivals[0]) + live.window_us
                     if live_active and n else float("inf"))
    window_idx = 0
    pending: list[deque] = [deque() for _ in range(n_channels)]

    def _run_chunk(c: int) -> None:
        """Serve one pending program chunk on channel ``c`` (in-band)."""
        nonlocal busy, energy
        ev, (pcounts, nblk) = pending[c].popleft()
        pr = sims[c].program_pass(pcounts, nblk)
        free[c] = max(float(free[c]), ev.t_fire_us) + pr.latency_us
        busy += pr.latency_us
        energy += pr.energy_uj
        ev.program_latency_us += pr.latency_us
        ev.energy_uj += pr.energy_uj
        ev.t_done_us = max(ev.t_done_us, float(free[c]))
        ev.n_chunks += 1

    pos = 0
    while pos < n:
        c = int(np.argmin(free))               # earliest-free channel
        end, dispatch = batcher.next_span(arrivals, pos,
                                          device_free_us=float(free[c]))
        # window boundary crossed: evaluate the trigger at the boundary the
        # lane's dispatch clock just passed (batch-granular, §5.3).
        while dispatch >= next_boundary:
            plan = engine.live_remap_step(trigger, window_idx)
            t_fire = next_boundary
            window_idx += 1
            next_boundary += live.window_us
            if plan is None:
                continue
            remap_events.append(RemapEvent(t_fire_us=t_fire, plan=plan))
            if plan.n_pages_moved == 0:
                continue
            for sim in sims:
                sim.reset_state()   # mappings swapped under every channel
            chunks = _chunk_program_work(plan, live.chunk_pages)
            for j, chunk in enumerate(chunks):
                pending[j % n_channels].append((remap_events[-1], chunk))
        if pending[c]:
            # one program chunk rides ahead of this channel's next batch —
            # the rewrite interleaves with serving instead of stopping it.
            _run_chunk(c)
            end, dispatch = batcher.next_span(arrivals, pos,
                                              device_free_us=float(free[c]))
        lo, hi = offsets[pos], offsets[end]
        tables, rows = tab_all[lo:hi], row_all[lo:hi]
        start = max(dispatch, float(free[c]))
        # channel-stall events push the batch start past the window; the
        # windows are (t0,t1)-sorted, so one forward pass resolves chains
        # of overlapping stalls (DESIGN.md §9.3).
        for ch, t0, t1 in stalls:
            if (ch is None or ch == c) and t0 <= start < t1:
                start = t1
        if record_window:
            engine.record_window(tables, rows)
        res = sims[c].run(tables, rows)
        svc = res.latency_us
        free[c] = start + svc
        busy += svc
        energy += res.energy_uj
        done = float(free[c])
        span = order[pos:end]
        latencies[span] = done - arrivals[pos:end]
        completions[span] = done
        if fault is not None:
            n_retries += res.n_retries
            n_uce += res.n_uncorrectable
            n_bad += res.n_badblock_reads
            if res.retry_hist is not None:
                retry_hist = (res.retry_hist.copy() if retry_hist is None
                              else retry_hist + res.retry_hist)
            if res.failed is not None and res.failed.any():
                # per-request OR over the batch's access slices: a request
                # fails iff any of its accesses rode an uncorrectable read
                boffs = (offsets[pos:end + 1] - lo).astype(np.int64)
                cnts = np.diff(boffs)
                fsum = np.add.reduceat(res.failed.astype(np.int64),
                                       np.minimum(boffs[:-1], res.failed.size - 1))
                req_failed = (fsum > 0) & (cnts > 0)
                if req_failed.any():
                    span_f = span[req_failed]
                    failed_mask[span_f] = True
                    # the host learns of the error when the batch returns
                    failed_detect[span_f] = done
        batches.append(Batch(requests=reqs[pos:end], tables=tables,
                             rows=rows, dispatch_us=dispatch))
        batch_channels.append(c)
        batch_starts.append(start)
        pos = end
    # drain program chunks the stream ended before absorbing: they still
    # cost channel time and energy, but no request waits on them.
    for c in range(n_channels):
        while pending[c]:
            _run_chunk(c)
    first_arrival = min(r.arrival_us for r in requests) if requests else 0.0
    if fault is not None:
        if n and np.isfinite(t_fail):
            # whole-device failure (DESIGN.md §9.3): every request whose
            # completion projects past the death instant never returns.
            # The host detects it at max(arrival, T_fail) — failover
            # re-dispatches from there. (The device's channel-busy time
            # past T_fail is still counted; documented over-count.)
            dead = completions > t_fail
            failed_mask |= dead
            failed_detect[dead] = np.maximum(arr_in[dead], t_fail)
        # failed requests return an error, not data: NaN latency (same
        # sentinel as shed, told apart by failed_mask)
        latencies[failed_mask] = np.nan
        completions[failed_mask] = np.nan
    # makespan spans the served subset only; NaN completions (failed
    # requests) must never leak into it regardless of the fault lane
    fin = completions[np.isfinite(completions)]
    makespan = (float(fin.max()) - first_arrival) if fin.size else 0.0
    # device_busy_frac = mean per-channel utilisation (== total busy /
    # makespan for a single-channel lane, unchanged from the old report).
    report = summarize(name, latencies, makespan,
                       [b.size for b in batches], busy / n_channels, energy,
                       n_failed=(int(failed_mask.sum())
                                 if failed_mask is not None else 0),
                       n_retries=n_retries, n_uncorrectable=n_uce,
                       retry_hist=retry_hist)
    return LaneTrace(report=report, batches=batches, latencies_us=latencies,
                     completions_us=completions, index_of=index_of,
                     n_channels=n_channels,
                     batch_channels=np.asarray(batch_channels, dtype=np.int64),
                     batch_starts_us=np.asarray(batch_starts,
                                                dtype=np.float64),
                     remap_events=remap_events, busy_us=busy,
                     failed_mask=failed_mask, failed_detect_us=failed_detect,
                     n_retries=n_retries, n_uncorrectable=n_uce,
                     n_badblock_reads=n_bad, retry_hist=retry_hist)


def replay_sharded(requests: list[Request], engine: ShardedEngine,
                   batcher_cfg: BatcherConfig | None = None,
                   record_window: bool = False,
                   policy_name: str | None = None,
                   n_channels: int = 1,
                   trigger: ThresholdTrigger | PeriodTrigger | None = None,
                   live: LiveRemapConfig | None = None,
                   slo: SLOConfig | None = None,
                   host_cache: "HostCacheBinding | None" = None
                   ) -> LaneTrace:
    """Scatter-gather replay over N simulated SSDs (DESIGN.md §6.2).

    **Scatter** — the stream is routed once through the engine's
    :class:`~repro_torch.core.engine.ShardPlan`; each request fans out into one
    sub-request per device that owns any of its tables/rows, carrying the
    device-local (table, row) ids in the original access order. **Per
    device** — each device runs the ordinary single-device :func:`replay`
    over its sub-stream: its own dynamic batcher, its own
    earliest-free-channel dispatch over its own ``n_channels`` channels,
    its own window recording and (with ``trigger`` + ``live``) its own
    device-local in-band remap loop — devices share nothing, so their
    simulated clocks advance independently. **Gather** — a request
    completes at the **max** of its per-device sub-completions (the gather
    barrier: the host reassembles the SLS result only when the last owning
    device answers) and its latency is that barrier minus arrival.

    With ``n_devices == 1`` every array the single device sees is
    value-identical to the unsharded stream, so the result is bit-identical
    to :func:`replay` (regression-tested).

    The returned trace aggregates the lane: ``busy_us``/energy sum over
    devices, ``batch_channels`` hold global channel ids
    (``device * n_channels + channel``), ``remap_events`` merge in firing
    order, and per-device sub-traces stay available as ``device_traces``.

    With ``slo`` each device runs its own SLO lane over its sub-stream
    (sub-requests inherit the parent's class). A request shed on **any**
    owning device is shed overall — its NaN sub-completion survives the
    max-gather, so the barrier rule needs no special case — and degraded
    on any device means degraded overall (DESIGN.md §7.5).

    With ``host_cache`` the host-DRAM tier short-circuits the stream
    *before* the scatter (DESIGN.md §10.2) — a fully-hit request never
    fans out to any device — and only the miss residue is sharded.
    """
    if slo is not None and (trigger is not None or live is not None):
        raise ValueError("slo scheduling and live remap do not "
                         "compose; configure one mid-stream loop")
    if host_cache is not None:
        return _host_cache_replay(
            requests, host_cache,
            lambda sub: replay_sharded(sub, engine, batcher_cfg,
                                       record_window=record_window,
                                       policy_name=policy_name,
                                       n_channels=n_channels,
                                       trigger=trigger, live=live,
                                       slo=slo),
            name=policy_name or engine.policy.name,
            n_channels=n_channels, slo=slo)
    nd = engine.plan.n_devices
    name = policy_name or engine.policy.name
    n = len(requests)
    index_of = {r.rid: i for i, r in enumerate(requests)}
    if len(index_of) != n:
        raise ValueError("duplicate request rids in stream")
    # scatter: route the whole stream's concatenated accesses in one pass
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([r.rows.size for r in requests], out=offsets[1:])
    tab_all = (np.concatenate([r.tables for r in requests]) if n
               else np.empty(0, dtype=np.int64))
    row_all = (np.concatenate([r.rows for r in requests]) if n
               else np.empty(0, dtype=np.int64))
    dev, ltab, lrow = engine.plan.route(tab_all, row_all)
    repl = getattr(engine, "replication", None)
    n_repl = repl.n_replicas if repl is not None else 0
    sub: list[list[Request]] = [[] for _ in range(nd)]
    members: list[list[int]] = [[] for _ in range(nd)]  # input positions
    # global (table, row) slice per sub-request — the replica tier routes
    # failures/hedges through plan.replica_route on global ids (§9.2)
    sub_tabs: list[list[np.ndarray]] = [[] for _ in range(nd)]
    sub_rows: list[list[np.ndarray]] = [[] for _ in range(nd)]
    for i, r in enumerate(requests):
        lo, hi = int(offsets[i]), int(offsets[i + 1])
        dslice = dev[lo:hi]
        for d in np.unique(dslice):
            sel = dslice == d
            sub[d].append(r.subset(ltab[lo:hi][sel], lrow[lo:hi][sel]))
            members[d].append(i)
            if n_repl:
                sub_tabs[d].append(tab_all[lo:hi][sel])
                sub_rows[d].append(row_all[lo:hi][sel])
    # per-device single-device replay (independent simulated clocks)
    arrivals = np.fromiter((r.arrival_us for r in requests),
                           dtype=np.float64, count=n)
    completions = np.zeros(n, dtype=np.float64)
    device_traces: list[LaneTrace] = []
    for d in range(nd):
        tr = replay(sub[d], engine.devices[d], batcher_cfg,
                    record_window=record_window, policy_name=name,
                    n_channels=n_channels, trigger=trigger, live=live,
                    slo=slo)
        device_traces.append(tr)
    # replica tier (DESIGN.md §9.2/§9.3): failed sub-requests re-dispatch
    # their replicated rows to the least-loaded hot-set replica; with
    # hedging on, slow-but-healthy fully-covered sub-requests get a
    # duplicate and take the min completion. ``eff[d][i]`` is device d's
    # effective completion for its i-th sub-request after both.
    failed_final = (np.zeros(n, dtype=bool)
                    if (n_repl or any(tr.failed_mask is not None
                                      for tr in device_traces)) else None)
    degraded_fail = np.zeros(n, dtype=bool) if n_repl else None
    replica_traces: list[LaneTrace] | None = None
    n_hedged = hedge_wins = n_failover = 0
    if n_repl:
        eff = [tr.completions_us.copy() for tr in device_traces]
        repl_reqs: list[list[Request]] = [[] for _ in range(n_repl)]
        repl_targets: list[list[tuple[int, int, str]]] = [
            [] for _ in range(n_repl)]
        repl_load = [0] * n_repl    # accumulated lookups (greedy)

        def _least_loaded() -> int:
            return min(range(n_repl), key=lambda j: repl_load[j])

        for d, tr in enumerate(device_traces):
            if not members[d]:
                continue
            arr_d = np.fromiter((r.arrival_us for r in sub[d]),
                                dtype=np.float64, count=len(sub[d]))
            if tr.failed_mask is not None and tr.failed_mask.any():
                for i in np.flatnonzero(tr.failed_mask).tolist():
                    gt, gr = sub_tabs[d][i], sub_rows[d][i]
                    cov, lr = engine.plan.replica_route(gt, gr)
                    if not cov.any():
                        # nothing replicated: the failure stands
                        failed_final[members[d][i]] = True
                        continue
                    j = _least_loaded()
                    repl_load[j] += int(cov.sum())
                    repl_reqs[j].append(Request(
                        rid=len(repl_reqs[j]),
                        arrival_us=float(tr.failed_detect_us[i]),
                        tables=gt[cov], rows=lr[cov], slo=sub[d][i].slo))
                    repl_targets[j].append((d, i, "failover"))
                    n_failover += 1
                    if not cov.all():
                        # cold rows dropped — the degrade rung (§9.2)
                        degraded_fail[members[d][i]] = True
            if repl.hedge:
                # asymmetric-EWMA tail estimator (~p95 chase), warmed
                # causally: only completions <= this arrival feed it.
                comp_d = tr.completions_us
                lat_d = comp_d - arr_d
                up = min(1.0, repl.hedge_alpha * repl.hedge_boost)
                dn = repl.hedge_alpha
                heap: list[tuple[float, float]] = []
                est = None
                for i in np.argsort(arr_d, kind="stable").tolist():
                    ai = float(arr_d[i])
                    while heap and heap[0][0] <= ai:
                        _, x = heapq.heappop(heap)
                        est = (x if est is None else
                               est + (up if x > est else dn) * (x - est))
                    li = float(lat_d[i])
                    if (est is not None and np.isfinite(li) and li > est):
                        gt, gr = sub_tabs[d][i], sub_rows[d][i]
                        cov, lr = engine.plan.replica_route(gt, gr)
                        if cov.all():   # hedge only fully-hot sub-requests
                            j = _least_loaded()
                            repl_load[j] += int(lr.size)
                            repl_reqs[j].append(Request(
                                rid=len(repl_reqs[j]), arrival_us=ai,
                                tables=gt, rows=lr, slo=sub[d][i].slo))
                            repl_targets[j].append((d, i, "hedge"))
                            n_hedged += 1
                    if np.isfinite(comp_d[i]):
                        heapq.heappush(heap, (float(comp_d[i]), li))
        replica_traces = []
        for j in range(n_repl):
            rtr = replay(repl_reqs[j], engine.replicas[j], batcher_cfg,
                         policy_name=f"{name}/replica{j}",
                         n_channels=n_channels)
            replica_traces.append(rtr)
            for k, (d, i, kind) in enumerate(repl_targets[j]):
                rc = float(rtr.completions_us[k])
                r_ok = np.isfinite(rc) and not (
                    rtr.failed_mask is not None and rtr.failed_mask[k])
                if kind == "failover":
                    if r_ok:
                        eff[d][i] = rc
                    else:
                        failed_final[members[d][i]] = True
                elif r_ok and rc < eff[d][i]:
                    eff[d][i] = rc
                    hedge_wins += 1
    else:
        eff = [tr.completions_us for tr in device_traces]
        if failed_final is not None:
            for d, tr in enumerate(device_traces):
                if tr.failed_mask is not None and members[d]:
                    pos = np.asarray(members[d], dtype=np.int64)
                    failed_final[pos] |= tr.failed_mask
    for d, tr in enumerate(device_traces):
        if members[d]:
            pos = np.asarray(members[d], dtype=np.int64)
            # gather barrier: completion = max over owning devices. A NaN
            # sub-completion (shed or failed on that device) survives
            # np.maximum, so a partially-shed request is shed overall
            # (DESIGN.md §7.5) and an unrecovered failure fails it (§9.2).
            with np.errstate(invalid="ignore"):
                np.maximum.at(completions, pos, eff[d])
    if failed_final is not None and failed_final.any():
        # a failure no replica recovered fails the whole request
        completions[failed_final] = np.nan
    # detect-time gather: the host notices a request failed when the
    # *first* owning device's failure is detected (fmin ignores the NaN
    # sentinel on healthy devices); requests a replica recovered carry
    # no detect time, like in the single-device lane.
    failed_detect = None
    if failed_final is not None:
        failed_detect = np.full(n, np.nan)
        for d, tr in enumerate(device_traces):
            if members[d] and tr.failed_detect_us is not None:
                pos = np.asarray(members[d], dtype=np.int64)
                np.fmin.at(failed_detect, pos, tr.failed_detect_us)
        failed_detect[~failed_final] = np.nan
    latencies = completions - arrivals
    # SLO gather extras: class from the parent requests; shed overall iff
    # any owning device shed (the NaN already encodes it); degraded
    # overall iff any owning device degraded (OR-scatter of sub-masks).
    slo_classes = shed_mask = degraded_mask = None
    slo_events: list = []
    n_preempted = 0
    if slo is not None:
        from repro_torch.serving.slo_scheduler import SLO_CLASSES
        slo_classes = np.fromiter(
            (SLO_CLASSES.index(r.slo) for r in requests),
            dtype=np.int64, count=n)
        shed_mask = ~np.isfinite(completions) if n else np.zeros(0, bool)
        if failed_final is not None:
            # shed is a policy decision; device failures are n_failed
            shed_mask &= ~failed_final
        degraded_mask = np.zeros(n, dtype=bool)
        for d, tr in enumerate(device_traces):
            if members[d] and tr.degraded_mask is not None:
                pos = np.asarray(members[d], dtype=np.int64)
                degraded_mask[pos] |= tr.degraded_mask
            n_preempted += tr.n_preempted
        slo_events = sorted((ev for tr in device_traces
                             for ev in tr.slo_events),
                            key=lambda ev: ev.t_us)
    if degraded_fail is not None and degraded_fail.any():
        # failover served these hot-only (cold rows dropped, §9.2) — the
        # same degrade rung the SLO ladder uses
        if degraded_mask is None:
            degraded_mask = degraded_fail
        else:
            degraded_mask = degraded_mask | degraded_fail
    # lane-level aggregation (replica lanes fold into busy/energy/batches
    # with channel ids after the primaries: replica j's channels are
    # [(nd + j) * n_channels, (nd + j + 1) * n_channels))
    all_traces = device_traces + (replica_traces or [])
    busy = sum(tr.busy_us for tr in all_traces)
    energy = sum(tr.report.energy_uj for tr in all_traces)
    n_retries = sum(tr.n_retries for tr in all_traces)
    n_uce = sum(tr.n_uncorrectable for tr in all_traces)
    n_bad = sum(tr.n_badblock_reads for tr in all_traces)
    retry_hist = None
    for tr in all_traces:
        if tr.retry_hist is not None:
            retry_hist = (tr.retry_hist.copy() if retry_hist is None
                          else retry_hist + tr.retry_hist)
    batches: list[Batch] = []
    batch_channels: list[int] = []
    batch_starts: list[float] = []
    for d, tr in enumerate(all_traces):
        batches.extend(tr.batches)
        batch_channels.extend((d * n_channels + c)
                              for c in tr.batch_channels.tolist())
        batch_starts.extend(tr.batch_starts_us.tolist())
    remap_events = sorted((ev for tr in device_traces
                           for ev in tr.remap_events),
                          key=lambda ev: ev.t_fire_us)
    first_arrival = float(arrivals.min()) if n else 0.0
    fin = completions[np.isfinite(completions)]
    makespan = (float(fin.max()) - first_arrival) if fin.size else 0.0
    span = max(makespan, 1e-9)
    per_class = {}
    if slo is not None:
        from repro_torch.serving.metrics import summarize_classes
        from repro_torch.serving.slo_scheduler import SLO_CLASSES
        per_class = summarize_classes(name, slo_classes, latencies,
                                      makespan, shed_mask, degraded_mask,
                                      SLO_CLASSES,
                                      failed_mask=failed_final)
    report = summarize(
        name, latencies, makespan, [b.size for b in batches],
        busy / (len(all_traces) * n_channels), energy, n_devices=nd,
        device_busy_fracs=tuple(tr.busy_us / n_channels / span
                                for tr in device_traces),
        n_shed=int(shed_mask.sum()) if shed_mask is not None else 0,
        n_degraded=(int(degraded_mask.sum())
                    if degraded_mask is not None else 0),
        per_class=per_class,
        n_failed=(int(failed_final.sum())
                  if failed_final is not None else 0),
        n_retries=n_retries, n_uncorrectable=n_uce,
        retry_hist=retry_hist, n_hedged=n_hedged,
        hedge_wins=hedge_wins, n_failover=n_failover)
    return LaneTrace(report=report, batches=batches, latencies_us=latencies,
                     completions_us=completions, index_of=index_of,
                     n_channels=n_channels,
                     batch_channels=np.asarray(batch_channels,
                                               dtype=np.int64),
                     batch_starts_us=np.asarray(batch_starts,
                                                dtype=np.float64),
                     remap_events=remap_events, busy_us=busy,
                     n_devices=nd, device_traces=device_traces,
                     slo_classes=slo_classes, shed_mask=shed_mask,
                     degraded_mask=degraded_mask, n_preempted=n_preempted,
                     slo_events=slo_events,
                     failed_mask=failed_final, failed_detect_us=failed_detect,
                     n_retries=n_retries, n_uncorrectable=n_uce,
                     n_badblock_reads=n_bad, retry_hist=retry_hist,
                     n_hedged=n_hedged, hedge_wins=hedge_wins,
                     n_failover=n_failover, replica_traces=replica_traces)


class ServingScheduler:
    """Deprecated: use ``repro_torch.serving.Deployment`` (one facade that also
    owns the offline phase, triggers, and multi-channel lanes)."""

    def __init__(self, engines: dict[str, RecFlashEngine],
                 batcher_cfg: BatcherConfig | None = None,
                 n_channels: int = 1) -> None:
        warnings.warn(
            "ServingScheduler is deprecated; use repro_torch.serving.Deployment",
            DeprecationWarning, stacklevel=2)
        if not engines:
            raise ValueError("need at least one policy engine")
        self.engines = engines
        self.batcher_cfg = batcher_cfg or BatcherConfig()
        self.n_channels = n_channels

    def run(self, requests: list[Request],
            record_window: bool = False) -> dict[str, LaneTrace]:
        """Replay the stream through every policy lane; {policy: trace}."""
        return {pol: replay(requests, eng, self.batcher_cfg,
                            record_window=record_window, policy_name=pol,
                            n_channels=self.n_channels)
                for pol, eng in self.engines.items()}
