"""SLO-aware continuous scheduler over the policy lane (DESIGN.md §7).

The plain replay (``serving/scheduler.py``) treats every request the same:
under saturation the whole stream's tail degrades together. Production
recommendation serving cannot accept that — RecSSD/RecNMP (PAPERS.md)
both frame SSD/near-memory embedding serving around strict tail SLAs
where latency-critical traffic must stay bounded while bulk traffic
absorbs the overload. This module is that dispatch discipline, run on the
same deterministic simulated clock so every decision is exactly
assertable.

Three priority classes (``workload.SLO_CLASSES``), strict service order:

* ``latency_critical`` — interactive ranking; tight deadline, never waits
  to batch (``lc_max_wait_us``, default 0);
* ``standard``         — ordinary inference; may be *degraded* to
  hot-rows-only service under projected deadline miss;
* ``bulk``             — precompute / backfill scans; batch-size-capped
  (preemption boundary) and first against the wall (*shed*) when stale.

The scheduler is continuous (DESIGN.md §7.2): each iteration takes the
earliest-free channel, advances the decision clock to
``max(channel_free, earliest pending head)`` (work-conserving — it never
idles a channel while any class has arrived work), and serves the
highest-priority class whose head has arrived. Admission against a
projected-queue-delay estimate (§7.3): an EWMA of per-request service
time per class projects each candidate batch's busy horizon; a bulk batch
is capped so the horizon it adds ahead of a pending latency-critical
request stays under ``headroom x deadline_lc_us`` (the reserve-ratio
admission idea of rtp-llm's FIFOScheduler, applied to channel time
instead of KV blocks). Because batches are atomic device commands,
preemption happens at batch *boundaries* only — the cap IS the
preemption, bounding how long a cold bulk scan can hold a channel.

Overload ladder (§7.3), gentlest first, every rung recorded on the trace:

1. **preempt**  — bulk batch size tightened below ``bulk_chunk`` because
   a latency-critical request is pending;
2. **degrade**  — a standard batch projected past its head's deadline is
   served hot-rows-only (the controller P$ answer; cold lookups dropped);
3. **shed**     — a bulk head staler than ``shed_after x deadline_bulk_us``
   is dropped unserved (NaN latency/completion, counted per class).

With a single class and infinite deadlines the loop degenerates to
exactly the plain replay's dispatch sequence (property-tested
bit-identical), and ``SLOConfig`` absent from a ``DeploymentConfig``
means this module never runs at all.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.engine import RecFlashEngine
from repro_torch.serving.batcher import Batch, BatcherConfig, DynamicBatcher
from repro_torch.serving.metrics import summarize, summarize_classes
from repro_torch.serving.workload import SLO_CLASSES, Request

if TYPE_CHECKING:  # lazy at runtime (scheduler imports our slo_replay)
    from repro_torch.serving.host_cache import HostCacheBinding
    from repro_torch.serving.scheduler import LaneTrace

# class indices into SLO_CLASSES (priority order, highest first)
LC, STD, BULK = 0, 1, 2
_NC = len(SLO_CLASSES)


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Knobs of the SLO lane (DESIGN.md §7.1); JSON-flat for deployment.

    Deadlines are per-class latency budgets measured from arrival.
    ``mix`` is the class-probability tuple ``assign_slo_classes`` draws
    from when a deployment annotates its own stream. ``bulk_chunk`` is
    the unconditional bulk batch cap (the preemption boundary);
    ``headroom`` scales how much projected channel time a bulk batch may
    put in front of a pending latency-critical request (fraction of
    ``deadline_lc_us``). ``shed_after`` multiplies ``deadline_bulk_us``
    into the staleness limit past which a bulk head is dropped unserved.
    ``ewma`` is the service-estimate smoothing factor (1.0 = last batch
    only).
    """

    deadline_lc_us: float = 2_000.0
    deadline_std_us: float = 20_000.0
    deadline_bulk_us: float = 200_000.0
    mix: tuple = (0.2, 0.5, 0.3)
    bulk_chunk: int = 8
    headroom: float = 0.5
    shed_after: float = 1.0
    degrade: bool = True
    lc_max_wait_us: float = 0.0
    ewma: float = 0.25

    def __post_init__(self) -> None:
        for f in ("deadline_lc_us", "deadline_std_us", "deadline_bulk_us"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")
        mix = tuple(float(x) for x in self.mix)
        object.__setattr__(self, "mix", mix)
        if (len(mix) != _NC or any(x < 0 for x in mix)
                or sum(mix) <= 0):
            raise ValueError(f"mix must be {_NC} non-negative weights "
                             "with a positive sum")
        if self.bulk_chunk < 1:
            raise ValueError("bulk_chunk must be >= 1")
        if self.headroom <= 0:
            raise ValueError("headroom must be positive")
        if self.shed_after <= 0:
            raise ValueError("shed_after must be positive")
        if self.lc_max_wait_us < 0:
            raise ValueError("lc_max_wait_us must be >= 0")
        if not 0.0 < self.ewma <= 1.0:
            raise ValueError("ewma must be in (0, 1]")

    @property
    def deadlines_us(self) -> tuple:
        """Per-class deadline tuple indexed like ``SLO_CLASSES``."""
        return (self.deadline_lc_us, self.deadline_std_us,
                self.deadline_bulk_us)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mix"] = list(self.mix)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SLOConfig":
        d = dict(d)
        if "mix" in d and d["mix"] is not None:
            d["mix"] = tuple(d["mix"])
        return cls(**d)


@dataclasses.dataclass
class SLOEvent:
    """One recorded scheduling decision (shed / degrade / preempt)."""

    t_us: float              # simulated time the decision was taken
    kind: str                # "shed" | "degrade" | "preempt"
    slo: str                 # class the decision applied to
    rids: tuple = ()         # affected request ids (empty for preempt)
    dropped_lookups: int = 0  # degrade only: cold accesses not served


def hot_row_mask(engine: RecFlashEngine) -> tuple[np.ndarray, np.ndarray]:
    """Flat hot-row membership over the concatenated row spaces.

    Returns ``(mask, row_offset)``: ``mask[row_offset[t] + row]`` is True
    iff ``row`` is among table ``t``'s ``hot_frac`` most-accessed rows
    under the engine's offline stats — the rows a remapping policy pins
    hot (and the P$ keeps resident), i.e. what degraded standard service
    can still answer (DESIGN.md §7.3).
    """
    row_offset = np.zeros(len(engine.tables) + 1, dtype=np.int64)
    np.cumsum([t.n_rows for t in engine.tables], out=row_offset[1:])
    mask = np.zeros(int(row_offset[-1]), dtype=bool)
    for t, (spec, st) in enumerate(zip(engine.tables, engine.stats, strict=True)):
        rank = st.rank_order()
        n_hot = max(1, int(engine.hot_frac * spec.n_rows))
        mask[row_offset[t] + rank[:n_hot]] = True
    return mask, row_offset


def slo_replay(requests: list[Request], engine: RecFlashEngine,
               slo: SLOConfig,
               batcher_cfg: BatcherConfig | None = None,
               record_window: bool = False,
               policy_name: str | None = None,
               n_channels: int = 1,
               host_cache: "HostCacheBinding | None" = None) -> LaneTrace:
    """Run one policy lane under the SLO discipline (module docstring).

    Same contract as :func:`repro_torch.serving.scheduler.replay` — returns a
    :class:`~repro_torch.serving.scheduler.LaneTrace` — with the SLO extras
    populated: per-request class/shed/degrade arrays (input order), the
    decision event log, and a per-class report under
    ``trace.report.per_class``. Shed requests carry NaN
    latency/completion. Live remap is the other mid-stream control loop
    and is not composed with this one (``DeploymentConfig`` rejects the
    combination).

    With ``host_cache`` (DESIGN.md §10.2) the host-DRAM tier
    short-circuits the stream first — fully-hit requests complete at
    DRAM latency regardless of class (the tier sits above the dispatch
    discipline), and only the miss residue competes for channels here.
    """
    from repro_torch.serving.scheduler import LaneTrace

    if host_cache is not None:
        from repro_torch.serving.scheduler import _host_cache_replay
        return _host_cache_replay(
            requests, host_cache,
            lambda sub: slo_replay(sub, engine, slo, batcher_cfg,
                                   record_window=record_window,
                                   policy_name=policy_name,
                                   n_channels=n_channels),
            name=policy_name or engine.policy.name,
            n_channels=n_channels, slo=slo)
    batcher = DynamicBatcher(batcher_cfg)
    name = policy_name or engine.policy.name
    n = len(requests)
    index_of = {r.rid: i for i, r in enumerate(requests)}
    if len(index_of) != n:
        raise ValueError("duplicate request rids in stream")
    # same stream order as replay: (arrival, rid)
    rids = np.fromiter((r.rid for r in requests), dtype=np.int64, count=n)
    arr_in = np.fromiter((r.arrival_us for r in requests),
                         dtype=np.float64, count=n)
    order = np.lexsort((rids, arr_in))
    reqs = [requests[i] for i in order.tolist()]
    arrivals = arr_in[order]
    try:
        cls_sorted = np.fromiter((SLO_CLASSES.index(r.slo) for r in reqs),
                                 dtype=np.int64, count=n)
    except ValueError:
        bad = sorted({r.slo for r in reqs} - set(SLO_CLASSES))
        raise ValueError(f"unknown SLO class(es) {bad}; have {SLO_CLASSES}")
    # per-class queues: positions into the sorted stream (arrival-sorted
    # subsequences), plus each class's own concatenated access arrays so a
    # class batch is a contiguous zero-copy span (DESIGN.md §3.3 idiom).
    q = [np.nonzero(cls_sorted == c)[0] for c in range(_NC)]
    arr_c = [arrivals[qc] for qc in q]
    offs_c, tab_c, row_c = [], [], []
    for c in range(_NC):
        members = [reqs[i] for i in q[c].tolist()]
        off = np.zeros(len(members) + 1, dtype=np.int64)
        np.cumsum([r.rows.size for r in members], out=off[1:])
        offs_c.append(off)
        tab_c.append(np.concatenate([r.tables for r in members])
                     if members else np.empty(0, dtype=np.int64))
        row_c.append(np.concatenate([r.rows for r in members])
                     if members else np.empty(0, dtype=np.int64))
    hp = [0] * _NC                      # per-class head pointer
    deadlines = slo.deadlines_us
    shed_limit = slo.shed_after * deadlines[BULK]
    hot_mask, row_offset = (hot_row_mask(engine) if slo.degrade
                            else (None, None))

    latencies = np.full(n, np.nan)
    completions = np.full(n, np.nan)
    shed_mask = np.zeros(n, dtype=bool)
    degraded_mask = np.zeros(n, dtype=bool)
    events: list[SLOEvent] = []
    n_preempted = 0
    batches: list[Batch] = []
    batch_channels: list[int] = []
    batch_starts: list[float] = []
    sims = engine.channel_sims(n_channels)
    for sim in sims:
        sim.reset_state()
    free = np.zeros(n_channels, dtype=np.float64)
    busy = 0.0
    energy = 0.0
    est = [0.0] * _NC                   # EWMA per-request service time
    # fault state (DESIGN.md §9.3) — inert without an active FaultConfig
    fault = getattr(engine, "fault", None)
    fault = fault if (fault is not None and fault.active) else None
    stalls = fault.stall_windows() if fault is not None else ()
    t_fail = fault.device_fail_at_us if fault is not None else float("inf")
    failed_mask = np.zeros(n, dtype=bool) if fault is not None else None
    failed_detect = np.full(n, np.nan) if fault is not None else None
    n_retries = n_uce = n_bad = 0
    retry_hist: np.ndarray | None = None

    def _remaining() -> list[int]:
        return [c for c in range(_NC) if hp[c] < q[c].size]

    while True:
        rem = _remaining()
        if not rem:
            break
        ch = int(np.argmin(free))       # earliest-free channel
        # decision clock: work-conserving across classes — the channel
        # never idles past the earliest pending head.
        now = max(float(free[ch]),
                  min(float(arr_c[c][hp[c]]) for c in rem))
        # shed rung: drop bulk heads staler than the limit at decision
        # time (lazy — staleness is judged when the head would be served,
        # not when it arrived). Dropping a head can raise the decision
        # clock, which can stale the next head: iterate to a fixed point.
        shed_rids: list[int] = []
        while (hp[BULK] < q[BULK].size
               and now - float(arr_c[BULK][hp[BULK]]) > shed_limit):
            gi = int(q[BULK][hp[BULK]])
            shed_mask[order[gi]] = True
            shed_rids.append(reqs[gi].rid)
            hp[BULK] += 1
            rem = _remaining()
            if not rem:
                break
            now = max(float(free[ch]),
                      min(float(arr_c[c][hp[c]]) for c in rem))
        if shed_rids:
            events.append(SLOEvent(t_us=now, kind="shed",
                                   slo=SLO_CLASSES[BULK],
                                   rids=tuple(shed_rids)))
        if not rem:
            break
        # strict priority: highest class whose head has arrived by now
        # (the class attaining the min above has, so this never misses).
        cls = next(c for c in rem if float(arr_c[c][hp[c]]) <= now)
        # per-class batch limits through the shared dispatch rule
        mb: int | None = None
        mw: float | None = None
        base_cap = 0
        if cls == LC:
            mw = slo.lc_max_wait_us
        elif cls == BULK:
            # the boundary cap composes with the batcher's own limit —
            # bulk_chunk only ever tightens, never widens, a batch
            base_cap = min(slo.bulk_chunk, batcher.cfg.max_batch)
            cap = base_cap
            if hp[LC] < q[LC].size and est[BULK] > 0.0:
                # admission estimator (§7.3): cap the projected channel
                # time this batch puts ahead of the pending LC request to
                # headroom x its deadline — but always admit one request,
                # so bulk starves, never deadlocks.
                cap = min(cap, max(1, int(deadlines[LC] * slo.headroom
                                          / est[BULK])))
            mb = cap
        end, dispatch = batcher.next_span(arr_c[cls], hp[cls],
                                          device_free_us=float(free[ch]),
                                          max_batch=mb, max_wait_us=mw)
        if (cls == BULK and mb is not None and mb < base_cap
                and end - hp[BULK] == mb and end < q[BULK].size
                and float(arr_c[BULK][end]) <= dispatch):
            # the estimator tightened the boundary below the standing cap
            # and work that was ready got pushed to the next batch: that
            # is the preemption, recorded as such.
            n_preempted += 1
            events.append(SLOEvent(t_us=dispatch, kind="preempt",
                                   slo=SLO_CLASSES[BULK]))
        lo, hi = offs_c[cls][hp[cls]], offs_c[cls][end]
        tables, rows = tab_c[cls][lo:hi], row_c[cls][lo:hi]
        start = max(dispatch, float(free[ch]))
        # channel-stall events push the batch start past the window
        # ((t0,t1)-sorted: one forward pass resolves chains, §9.3)
        for sch, t0, t1 in stalls:
            if (sch is None or sch == ch) and t0 <= start < t1:
                start = t1
        span = q[cls][hp[cls]:end]      # sorted-stream indices
        size = end - hp[cls]
        keep = None                     # degrade filter (fault attribution)
        if record_window:
            # the window records demand (what was asked), so a later
            # remap sees true popularity even when service was degraded
            engine.record_window(tables, rows)
        if (cls == STD and slo.degrade and est[STD] > 0.0
                and start + est[STD] * size
                > float(arr_c[STD][hp[cls]]) + deadlines[STD]):
            # degrade rung: projected past the head's deadline — serve
            # the hot-resident subset only, drop cold lookups.
            keep = hot_mask[row_offset[tables] + rows]
            dropped = int(keep.size - keep.sum())
            if dropped:
                degraded_mask[order[span]] = True
                events.append(SLOEvent(
                    t_us=start, kind="degrade", slo=SLO_CLASSES[STD],
                    rids=tuple(reqs[i].rid for i in span.tolist()),
                    dropped_lookups=dropped))
                tables, rows = tables[keep], rows[keep]
        if rows.size:
            res = sims[ch].run(tables, rows)
            svc = res.latency_us
            energy += res.energy_uj
        else:
            res = None
            svc = 0.0                   # fully degraded: P$ answers all
        free[ch] = start + svc
        busy += svc
        done = float(free[ch])
        oi = order[span]
        latencies[oi] = done - arrivals[span]
        completions[oi] = done
        if fault is not None and res is not None:
            n_retries += res.n_retries
            n_uce += res.n_uncorrectable
            n_bad += res.n_badblock_reads
            if res.retry_hist is not None:
                retry_hist = (res.retry_hist.copy() if retry_hist is None
                              else retry_hist + res.retry_hist)
            if res.failed is not None and res.failed.any():
                # per-request OR over the batch's access slices; a
                # degraded batch dropped cold accesses, so rebuild the
                # per-request offsets from the keep mask first (§9.3)
                boffs = (offs_c[cls][hp[cls]:end + 1] - lo).astype(np.int64)
                if keep is not None:
                    kc = np.add.reduceat(
                        keep.astype(np.int64),
                        np.minimum(boffs[:-1], keep.size - 1))
                    kc[np.diff(boffs) == 0] = 0
                    boffs = np.zeros(size + 1, dtype=np.int64)
                    np.cumsum(kc, out=boffs[1:])
                cnts = np.diff(boffs)
                fsum = np.add.reduceat(
                    res.failed.astype(np.int64),
                    np.minimum(boffs[:-1], res.failed.size - 1))
                req_failed = (fsum > 0) & (cnts > 0)
                if req_failed.any():
                    oi_f = order[span[req_failed]]
                    failed_mask[oi_f] = True
                    failed_detect[oi_f] = done
        batches.append(Batch(requests=[reqs[i] for i in span.tolist()],
                             tables=tables, rows=rows,
                             dispatch_us=dispatch))
        batch_channels.append(ch)
        batch_starts.append(start)
        per_req = svc / size
        est[cls] = (per_req if est[cls] == 0.0 else
                    (1.0 - slo.ewma) * est[cls] + slo.ewma * per_req)
        hp[cls] = end

    cls_in = np.zeros(n, dtype=np.int64)
    cls_in[order] = cls_sorted
    if fault is not None:
        if n and np.isfinite(t_fail):
            # whole-device failure: anything completing past the death
            # instant never returns (DESIGN.md §9.3); detection at
            # max(arrival, T_fail). Shed requests are already NaN.
            dead = completions > t_fail
            failed_mask |= dead
            failed_detect[dead] = np.maximum(arr_in[dead], t_fail)
        latencies[failed_mask] = np.nan
        completions[failed_mask] = np.nan
    fin = completions[np.isfinite(completions)]
    first_arrival = float(arr_in.min()) if n else 0.0
    makespan = (float(fin.max()) - first_arrival) if fin.size else 0.0
    per_class = summarize_classes(name, cls_in, latencies, makespan,
                                  shed_mask, degraded_mask, SLO_CLASSES,
                                  failed_mask=failed_mask)
    report = summarize(name, latencies, makespan,
                       [b.size for b in batches], busy / n_channels,
                       energy, n_shed=int(shed_mask.sum()),
                       n_degraded=int(degraded_mask.sum()),
                       per_class=per_class,
                       n_failed=(int(failed_mask.sum())
                                 if failed_mask is not None else 0),
                       n_retries=n_retries, n_uncorrectable=n_uce,
                       retry_hist=retry_hist)
    return LaneTrace(report=report, batches=batches,
                     latencies_us=latencies, completions_us=completions,
                     index_of=index_of, n_channels=n_channels,
                     batch_channels=np.asarray(batch_channels,
                                               dtype=np.int64),
                     batch_starts_us=np.asarray(batch_starts,
                                                dtype=np.float64),
                     busy_us=busy, slo_classes=cls_in,
                     shed_mask=shed_mask, degraded_mask=degraded_mask,
                     n_preempted=n_preempted, slo_events=events,
                     failed_mask=failed_mask,
                     failed_detect_us=failed_detect,
                     n_retries=n_retries, n_uncorrectable=n_uce,
                     n_badblock_reads=n_bad, retry_hist=retry_hist)
