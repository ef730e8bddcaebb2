"""RecFlash ISC engine — ties layout + cache + device + adaptive remap.

This is the system object the benchmarks and the online-training simulation
drive: it owns one ``SLSSimulator`` per policy, builds the frequency-based
mapping from sampled statistics (offline phase, Fig. 8), serves inference
batches, accumulates the online window's access counts, evaluates the trigger
policy, and executes the Algorithm-1 adaptive remap with its NAND rewrite
cost charged explicitly (Fig. 7 / Fig. 14 accounting).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.adaptive import AdaptiveHashTable, UpdateReport
from repro_torch.core.freq import AccessStats
from repro_torch.core.remap import Mapping, build_mapping, build_mapping_from_order
from repro_torch.core.triggers import PeriodTrigger, ThresholdTrigger
from repro_torch.flashsim.device import (CacheConfig, FaultConfig, FlashPart,
                                   PARTS, TIMING)
from repro_torch.flashsim.timeline import POLICIES, PolicyConfig, SimResult, SLSSimulator


@dataclasses.dataclass
class TableSpec:
    n_rows: int
    vec_bytes: int

    @property
    def table_bytes(self) -> int:
        return self.n_rows * self.vec_bytes


SHARD_STRATEGIES = ("table", "row")


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Replicated hot-set failover policy for a flash fleet (DESIGN.md §9.2).

    The top ``hot_frac`` rows of every table by sampled-frequency rank
    (the ``popularity_perm``/``rank_order`` convention) are mirrored on
    ``k - 1`` dedicated replica devices in addition to their primary —
    ``k`` copies total, RecNMP-style hot-set replication. Replicas may
    sit on a different (faster) flash part, e.g. SLC for the hot tier.

    ``hedge`` opts into hedged reads (Dean & Barroso tail-at-scale): a
    sub-request fully covered by the hot set gets a duplicate dispatched
    to the least-loaded replica when its primary device's projected
    completion exceeds ``hedge_percentile``-ish of that device's recent
    completions (asymmetric-EWMA tail estimate); the request completes
    at the min of the two.
    """

    k: int = 2                   # total copies of the hot set (1 = none)
    hot_frac: float = 0.1        # top share of each table replicated
    part: str | None = None      # replica flash part name (None = primary's)
    hedge: bool = False          # opt-in hedged reads
    hedge_alpha: float = 0.05    # EWMA step for the tail estimator
    hedge_boost: float = 20.0    # upper-side EWMA multiplier (~p95 chase)

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if not 0.0 < self.hot_frac <= 1.0:
            raise ValueError("hot_frac must be in (0, 1]")
        if self.part is not None and self.part not in PARTS:
            raise ValueError(f"unknown replica part {self.part!r}; "
                             f"have {tuple(PARTS)}")
        if not 0.0 < self.hedge_alpha <= 1.0:
            raise ValueError("hedge_alpha must be in (0, 1]")
        if self.hedge_boost < 1.0:
            raise ValueError("hedge_boost must be >= 1")

    @property
    def n_replicas(self) -> int:
        return self.k - 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ReplicationConfig":
        return cls(**d)


class ShardPlan:
    """Global (table, row) -> (device, local table, local row) routing
    for a multi-SSD deployment (DESIGN.md §6.1).

    Two strategies:

    * ``table`` — whole tables round-robined over devices (table ``t`` on
      device ``t % n_devices``); the classic RecSSD-style scale-out where
      every table fits one drive. Local row ids equal global row ids.
    * ``row``  — every device holds a slice of *every* table, rows striped
      over devices by **hot rank** (the sampled-frequency rank order, the
      same rank -> row convention ``popularity_perm``/``AccessStats.
      rank_order`` define): the row at rank ``g`` lives on device
      ``g % n_devices``. Striping by rank — not by row-id range — splits
      the hot set evenly, so no device becomes the hot-traffic straggler.
      Within a device, local row ids follow global row-id order (the
      device's own offline phase then re-sorts its slice by frequency
      exactly as a single-device deployment would).

    The plan is a property of the *deployment*, shared by every policy
    lane, so all policies see the identical device-level load split and
    differ only in their per-device physical page mapping.

    With a :class:`ReplicationConfig` the plan additionally carries the
    replica-group routing state (DESIGN.md §9.2): per table, the hot rows
    (by rank) mirrored on every replica device, and a dense
    ``replica_local_row`` array mapping global row -> replica-local row
    (``-1`` for unreplicated cold rows).
    """

    def __init__(self, tables: list[TableSpec],
                 stats: "list[AccessStats]", n_devices: int,
                 strategy: str = "table",
                 replication: "ReplicationConfig | None" = None) -> None:
        if n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if strategy not in SHARD_STRATEGIES:
            raise ValueError(f"unknown shard strategy {strategy!r}; "
                             f"have {SHARD_STRATEGIES}")
        if len(stats) != len(tables):
            raise ValueError("need one AccessStats per table")
        self.strategy = strategy
        self.n_devices = n_devices
        self.n_tables = len(tables)
        self.replication = replication
        # replica-group structures (empty without replication)
        self.replica_tables: list[TableSpec] = []
        self.replica_stats: list[AccessStats] = []
        self.hot_rows: list[np.ndarray] = []
        self.replica_local_row: list[np.ndarray] = []
        if replication is not None and replication.n_replicas > 0:
            for spec, st in zip(tables, stats, strict=True):
                n_hot = min(spec.n_rows, max(1, int(
                    np.ceil(replication.hot_frac * spec.n_rows))))
                hot = st.rank_order()[:n_hot]       # rank order
                local = np.full(spec.n_rows, -1, dtype=np.int64)
                local[hot] = np.arange(n_hot, dtype=np.int64)
                self.hot_rows.append(hot)
                self.replica_local_row.append(local)
                self.replica_tables.append(TableSpec(n_hot, spec.vec_bytes))
                self.replica_stats.append(AccessStats(st.counts[hot]))
        # per device: local TableSpecs and matching local AccessStats
        self.device_tables: list[list[TableSpec]] = []
        self.device_stats: list[list[AccessStats]] = []
        if strategy == "table":
            self.device_of_table = (np.arange(self.n_tables, dtype=np.int64)
                                    % n_devices)
            self.local_table_id = (np.arange(self.n_tables, dtype=np.int64)
                                   // n_devices)
            for d in range(n_devices):
                owned = np.flatnonzero(self.device_of_table == d)
                self.device_tables.append([tables[t] for t in owned])
                self.device_stats.append([stats[t] for t in owned])
            self.device_of_row = None
            self.local_row_id = None
        else:
            # row-wise: rank g -> device g % n_devices, per table
            self.device_of_table = None
            self.local_table_id = None
            self.device_of_row = []
            self.local_row_id = []
            owned_rows: list[list[np.ndarray]] = [[] for _ in
                                                  range(n_devices)]
            for t, (spec, st) in enumerate(zip(tables, stats, strict=True)):
                order = st.rank_order()            # rank -> global row
                dev = np.empty(spec.n_rows, dtype=np.int64)
                dev[order] = np.arange(spec.n_rows, dtype=np.int64) \
                    % n_devices
                local = np.empty(spec.n_rows, dtype=np.int64)
                for d in range(n_devices):
                    rows_d = np.flatnonzero(dev == d)   # global-id order
                    local[rows_d] = np.arange(rows_d.size, dtype=np.int64)
                    owned_rows[d].append(rows_d)
                self.device_of_row.append(dev)
                self.local_row_id.append(local)
            for d in range(n_devices):
                self.device_tables.append(
                    [TableSpec(owned_rows[d][t].size, tables[t].vec_bytes)
                     for t in range(self.n_tables)])
                self.device_stats.append(
                    [AccessStats(stats[t].counts[owned_rows[d][t]])
                     for t in range(self.n_tables)])

    def route(self, tables: np.ndarray, rows: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorised routing of one access stream.

        Returns ``(device, local_table, local_row)`` arrays aligned with
        the input; the access order within each device's sub-stream is the
        input order restricted to that device (the FTL sees sub-commands
        in arrival order, exactly like the single-device lane).
        """
        tables = np.asarray(tables, dtype=np.int64).ravel()
        rows = np.asarray(rows, dtype=np.int64).ravel()
        if self.strategy == "table":
            return (self.device_of_table[tables],
                    self.local_table_id[tables], rows)
        dev = np.empty(tables.size, dtype=np.int64)
        lrow = np.empty(rows.size, dtype=np.int64)
        for t in np.unique(tables):
            sel = tables == t
            dev[sel] = self.device_of_row[t][rows[sel]]
            lrow[sel] = self.local_row_id[t][rows[sel]]
        return dev, tables, lrow

    def replica_route(self, tables: np.ndarray, rows: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Replica-local routing of one access stream (DESIGN.md §9.2).

        Returns ``(covered, local_row)`` aligned with the input:
        ``covered[i]`` iff access ``i`` hits a replicated hot row, and
        ``local_row[i]`` is its row id on every replica device (valid only
        where covered; ``-1`` elsewhere). Replica table ids equal global
        table ids — each replica holds the hot slice of *every* table.
        """
        if not self.replica_local_row:
            raise ValueError("plan has no replication configured")
        tables = np.asarray(tables, dtype=np.int64).ravel()
        rows = np.asarray(rows, dtype=np.int64).ravel()
        lrow = np.empty(rows.size, dtype=np.int64)
        for t in np.unique(tables):
            sel = tables == t
            lrow[sel] = self.replica_local_row[t][rows[sel]]
        return lrow >= 0, lrow


@dataclasses.dataclass
class RemapPlan:
    """One incremental (in-band) adaptive remap: what physically moved.

    Produced by :meth:`RecFlashEngine.live_remap_step` after an
    Algorithm-1 update. Unlike the bulk ``remap_cost`` lump sum (which
    charges every hot *row* as if rewritten), the plan is a diff of the
    old vs new physical mapping restricted to the hot region: only pages
    whose contents actually changed are counted, and
    ``bytes_programmed == n_pages_moved * page_bytes`` by construction
    (DESIGN.md §5.3). ``plane_counts[p]`` is how many of those pages land
    on plane ``p`` — the serving lane turns it into in-band page-program
    traffic (``SLSSimulator.program_pass``).
    """

    n_pages_moved: int
    n_blocks: int
    bytes_programmed: int
    plane_counts: np.ndarray
    update_report: UpdateReport
    n_tables_updated: int = 0


@dataclasses.dataclass
class DayLog:
    day: int
    inference: SimResult
    triggered: bool = False
    remap_latency_us: float = 0.0
    remap_energy_uj: float = 0.0
    update_report: UpdateReport | None = None


class RecFlashEngine:
    """Offline remap + inference serving + online adaptive remapping."""

    def __init__(self, tables: list[TableSpec], part: FlashPart,
                 policy: str | PolicyConfig = "recflash",
                 sample_stats: list[AccessStats] | None = None,
                 hot_frac: float = 0.05,
                 cache_cfg: CacheConfig | None = None,
                 fault: FaultConfig | None = None) -> None:
        self.tables = tables
        self.part = part
        self.policy = POLICIES[policy] if isinstance(policy, str) else policy
        self.hot_frac = hot_frac
        # device-filtered fault model (DESIGN.md §9); the serving replay
        # reads it back for event (stall/device-fail) scheduling
        self.fault = fault
        self.stats = sample_stats or [
            AccessStats(np.zeros(t.n_rows, dtype=np.int64)) for t in tables]
        mappings = [self._build(t, s)
                    for t, s in zip(tables, self.stats, strict=True)]
        self.sim = SLSSimulator(part, self.policy, mappings, TIMING, cache_cfg,
                                fault=fault)
        # Algorithm-1 state (only meaningful for remapping policies)
        self.hash_tables: list[AdaptiveHashTable] = []
        if self.policy.mapping_mode != "baseline":
            for t, s in zip(tables, self.stats, strict=True):
                order = s.rank_order()
                self.hash_tables.append(AdaptiveHashTable(
                    keys=order, freqs=s.counts[order],
                    addrs=np.arange(t.n_rows), hot_frac=hot_frac))
        # online window accumulation (Fig. 6a) — one flat count array over
        # the concatenated per-table row spaces, exposed as per-table views.
        # A single fused bincount over (row_offset[table] + row) keys
        # records a whole command stream, so per-serve() python work stays
        # O(1) however many tables the command touches.
        self._row_offset = np.zeros(len(tables) + 1, dtype=np.int64)
        np.cumsum([t.n_rows for t in tables], out=self._row_offset[1:])
        self._window_flat = np.zeros(int(self._row_offset[-1]),
                                     dtype=np.int64)
        self._window: list[np.ndarray] = [
            self._window_flat[self._row_offset[t]:self._row_offset[t + 1]]
            for t in range(len(tables))]

    def _build(self, spec: TableSpec, stats: AccessStats) -> Mapping:
        return build_mapping(spec.n_rows, spec.vec_bytes,
                             self.part.page_bytes, self.part.n_planes,
                             mode=self.policy.mapping_mode, stats=stats)

    # -- serving -------------------------------------------------------------
    def serve(self, tables: np.ndarray, rows: np.ndarray,
              record_window: bool = False, window: int = 0,
              force_exact: bool = False) -> SimResult:
        """Serve one SLS command stream; optionally record the online window.

        ``window`` is forwarded to the simulator as the SLS command size
        (``0`` = the whole call is one command — what the dynamic batcher
        wants, since a coalesced batch IS one command, DESIGN.md §3).
        ``force_exact`` forwards to ``sim.run`` (DESIGN.md §2.3: replay the
        per-access loop instead of the vectorised fast path).
        """
        if record_window:
            self.record_window(tables, rows)
        return self.sim.run(tables, rows, window=window,
                            force_exact=force_exact)

    def record_window(self, tables: np.ndarray, rows: np.ndarray) -> None:
        """Accumulate one command stream into the online window (Fig. 6a).

        Split out of :meth:`serve` so multi-channel lanes can record once on
        the engine while service time is charged on a per-channel simulator.
        One fused bincount over per-table row-offset keys — no per-table
        python loop (equivalence-tested against the old per-unique-table
        ``np.unique`` + masked-bincount accumulation).
        """
        tables_arr = np.asarray(tables, dtype=np.int64).ravel()
        rows_arr = np.asarray(rows, dtype=np.int64).ravel()
        keys = self._row_offset[tables_arr] + rows_arr
        # an out-of-range row would silently land in the next table's
        # region of the flat window — reject it like the per-table
        # bincount used to
        if rows_arr.size and (int(rows_arr.min()) < 0 or np.any(
                keys >= self._row_offset[tables_arr + 1])):
            raise ValueError("row id out of range for its table")
        self._window_flat += np.bincount(keys,
                                         minlength=self._window_flat.size)

    def channel_sims(self, n_channels: int) -> list[SLSSimulator]:
        """Per-channel device views for a multi-channel lane (DESIGN.md §3.3).

        For ``n_channels=1`` this is the engine's own simulator, so the
        single-server path is reproduced exactly. For ``n > 1`` each channel
        is an independent ``SLSSimulator`` over the *same* mappings list —
        an online remap (``replace_mapping``) is visible to every channel —
        with private planes/page buffers and a 1/n *slice* of the one
        controller P$ SRAM (the 128 KB budget is a per-controller quantity;
        replicating it per channel would conflate channel concurrency with
        extra cache capacity).
        """
        if n_channels < 1:
            raise ValueError("n_channels must be >= 1")
        if n_channels == 1:
            return [self.sim]
        cache_cfg = self.sim.cache_cfg
        sliced = dataclasses.replace(
            cache_cfg, sram_bytes=cache_cfg.sram_bytes // n_channels)
        # per-channel fault substream: channels draw independent but
        # reproducible retry sequences (DESIGN.md §9.1)
        return [self.sim.fork(sliced, fault_stream=c)
                for c in range(n_channels)]

    def window_counts(self, tid: int) -> np.ndarray:
        """Dense access-count array for table ``tid``'s online window."""
        return self._window[tid]

    def window_dict(self, tid: int) -> dict[int, int]:
        """Sparse {row: count} view of the window (trigger/Alg.-1 input)."""
        w = self._window[tid]
        idx = np.flatnonzero(w)
        return dict(zip(idx.tolist(), w[idx].tolist(), strict=True))

    # -- online training / adaptive remap -------------------------------------
    def _eval_trigger(self, trigger: ThresholdTrigger | PeriodTrigger,
                      period_index: int, windows: list[dict]) -> bool:
        """One trigger evaluation over the current window (DESIGN.md §5.2).

        ``period_index`` is the trigger period ordinal — the day for the
        bulk loop, the window ordinal for the live lane. The threshold
        trigger fires iff any table saw enough *new* hot keys (keys already
        in the hot region are excluded — a stable distribution must not
        re-trigger).
        """
        if isinstance(trigger, PeriodTrigger):
            return trigger.should_trigger(period_index)
        return any(
            trigger.should_trigger(windows[t], ht.threshold_freq,
                                   frozenset(ht.hot_keys()))
            for t, ht in enumerate(self.hash_tables))

    def _update_table(self, tid: int, window: dict) -> tuple[UpdateReport,
                                                             Mapping, Mapping]:
        """Algorithm-1 update of one table; swap in the rebuilt mapping.

        Returns ``(report, old_mapping, new_mapping)`` so callers can
        charge the rewrite their own way (lump sum vs page diff). The
        rebuild keeps the hot region re-sorted and the cold tail in its
        (approximate) old placement — only hot + fresh rows move.
        """
        spec, ht = self.tables[tid], self.hash_tables[tid]
        report = ht.update(window)
        ht.compact()
        order = np.asarray(ht.keys_in_order(), dtype=np.int64)
        old = self.sim.mappings[tid]
        new = build_mapping_from_order(order, spec.vec_bytes,
                                       self.part.page_bytes,
                                       self.part.n_planes,
                                       mode=self.policy.mapping_mode)
        self.sim.replace_mapping(tid, new)
        return report, old, new

    def live_remap_step(self, trigger: ThresholdTrigger | PeriodTrigger,
                        period_index: int) -> RemapPlan | None:
        """Mid-stream trigger check + incremental remap (DESIGN.md §5.3).

        Called by the serving replay at window boundaries. Evaluates the
        trigger over the accumulated online window; when it fires, runs the
        Algorithm-1 update per table and diffs the old vs new physical
        mapping over the *hot region* — the pages that actually moved are
        returned as a :class:`RemapPlan` for the lane to program in-band
        (the mappings list is shared with every channel simulator, so the
        swap is immediately visible; the caller owns resetting per-channel
        read state). The window is cleared either way. Returns ``None``
        for baseline policies or when the trigger does not fire.

        Fresh keys direct-assigned into the cold tail would also cost page
        programs, but a serving deployment's hash tables are initialised
        with the full vocabulary, so every window key already exists and
        ``n_direct_assigned`` is structurally zero here.
        """
        if self.policy.mapping_mode == "baseline" or not self.hash_tables:
            self._clear_window()
            return None
        windows = [self.window_dict(t) for t in range(len(self.tables))]
        if not self._eval_trigger(trigger, period_index, windows):
            self._clear_window()
            return None
        plane_counts = np.zeros(self.part.n_planes, dtype=np.int64)
        n_pages = 0
        n_blocks = 0
        n_updated = 0
        merged = UpdateReport()
        for tid in range(len(self.tables)):
            if not windows[tid]:
                continue
            report, old, new = self._update_table(tid, windows[tid])
            n_updated += 1
            merged += report
            hot_rows = np.asarray(
                self.hash_tables[tid].hot_keys(), dtype=np.int64)
            op, og, os_ = old.lookup(hot_rows)
            np_, ng, ns = new.lookup(hot_rows)
            changed = (op != np_) | (og != ng) | (os_ != ns)
            moved, first = np.unique(ng[changed], return_index=True)
            n_pages += int(moved.size)
            plane_counts += np.bincount(np_[changed][first],
                                        minlength=self.part.n_planes)
            n_blocks += int(np.unique(
                moved // self.part.pages_per_block).size)
        self._clear_window()
        return RemapPlan(
            n_pages_moved=n_pages, n_blocks=n_blocks,
            bytes_programmed=n_pages * self.part.page_bytes,
            plane_counts=plane_counts, update_report=merged,
            n_tables_updated=n_updated)

    def maybe_remap(self, day: int,
                    trigger: ThresholdTrigger | PeriodTrigger) -> DayLog | None:
        """Evaluate the trigger at end of ``day``; remap hot region if fired.

        Returns a DayLog fragment with the remap cost, or None if not fired.
        For baseline policies this is a no-op (they redeploy tables whole as
        part of the normal pipeline — cost identical for both systems, paper
        §III-C4 — so we charge neither).
        """
        if self.policy.mapping_mode == "baseline" or not self.hash_tables:
            self._clear_window()
            return None
        # sparse views are O(n_rows) to build — materialise once per table
        # and share between the trigger check and the Algorithm-1 update.
        windows = [self.window_dict(t) for t in range(len(self.tables))]
        if not self._eval_trigger(trigger, day, windows):
            self._clear_window()
            return None

        total_lat = 0.0
        total_energy = 0.0
        merged = UpdateReport()
        for tid, spec in enumerate(self.tables):
            window = windows[tid]
            if not window:
                continue
            report, _, _ = self._update_table(tid, window)
            # bulk accounting (paper Fig. 14): every hot row charged as
            # rewritten, as one stop-the-world lump sum. The request-level
            # lane charges the page diff instead (live_remap_step).
            n_rewritten = report.n_remapped + report.n_direct_assigned
            lat, en = self.sim.remap_cost(n_rewritten, spec.vec_bytes)
            total_lat += lat
            total_energy += en
            merged += report
        self._clear_window()
        return DayLog(day=day, inference=SimResult(), triggered=True,
                      remap_latency_us=total_lat,
                      remap_energy_uj=total_energy, update_report=merged)

    def _clear_window(self) -> None:
        self._window_flat[:] = 0


class ShardedEngine:
    """N simulated SSDs behind one scatter-gather facade (DESIGN.md §6).

    Owns a :class:`ShardPlan` plus one :class:`RecFlashEngine` per device —
    each device gets its own ``FlashPart`` channel set, its own
    ``SLSSimulator`` state (page buffers, controller P$ SRAM) and its own
    online window / Algorithm-1 hash tables, built from the *local* slice
    of the deployment's sampled offline stats. Adaptive remapping is
    therefore device-local by construction: a device's trigger sees only
    the accesses routed to it and its rewrite traffic occupies only its
    own channels (§6.3).

    ``serve``/``maybe_remap`` mirror the single-device engine so the bulk
    online loop (``Deployment.step_day``) drives either transparently;
    devices operate in parallel, so a served command's latency is the max
    over devices while energy and access counters sum.
    """

    def __init__(self, tables: list[TableSpec], part: FlashPart,
                 policy: str | PolicyConfig = "recflash",
                 sample_stats: list[AccessStats] | None = None,
                 hot_frac: float = 0.05,
                 cache_cfg: CacheConfig | None = None,
                 n_devices: int = 2, shard: str = "table",
                 plan: ShardPlan | None = None,
                 fault: FaultConfig | None = None,
                 replication: ReplicationConfig | None = None) -> None:
        self.tables = tables
        self.part = part
        self.policy = POLICIES[policy] if isinstance(policy, str) else policy
        self.hot_frac = hot_frac
        self.fault = fault
        self.stats = sample_stats or [
            AccessStats(np.zeros(t.n_rows, dtype=np.int64)) for t in tables]
        # the plan depends only on (tables, stats, n_devices, shard,
        # replication), all policy-independent — a deployment builds it once
        # and passes the same instance to every policy lane's engine
        if plan is not None:
            if plan.n_devices != n_devices or plan.strategy != shard:
                raise ValueError("provided ShardPlan does not match "
                                 f"n_devices={n_devices}/shard={shard!r}")
            if plan.replication != replication:
                raise ValueError("provided ShardPlan was built with a "
                                 "different ReplicationConfig")
            self.plan = plan
        else:
            self.plan = ShardPlan(tables, self.stats, n_devices, shard,
                                  replication=replication)
        self.replication = self.plan.replication
        self.devices: list[RecFlashEngine] = [
            RecFlashEngine(self.plan.device_tables[d], part,
                           policy=self.policy,
                           sample_stats=self.plan.device_stats[d],
                           hot_frac=hot_frac, cache_cfg=cache_cfg,
                           fault=fault.for_device(d) if fault is not None
                           else None)
            for d in range(n_devices)]
        # dedicated hot-set replica devices (DESIGN.md §9.2): each holds
        # the top-ranked slice of every table, optionally on a faster part
        self.replicas: list[RecFlashEngine] = []
        repl = self.replication
        if repl is not None and repl.n_replicas > 0:
            rpart = PARTS[repl.part] if repl.part is not None else part
            self.replicas = [
                RecFlashEngine(self.plan.replica_tables, rpart,
                               policy=self.policy,
                               sample_stats=self.plan.replica_stats,
                               hot_frac=hot_frac, cache_cfg=cache_cfg,
                               fault=fault.for_replica(j)
                               if fault is not None else None)
                for j in range(repl.n_replicas)]

    @property
    def n_devices(self) -> int:
        return self.plan.n_devices

    # -- bulk serving (Deployment.step_day) -----------------------------------
    def serve(self, tables: np.ndarray, rows: np.ndarray,
              record_window: bool = False, window: int = 0,
              force_exact: bool = False) -> SimResult:
        """Scatter one bulk SLS command over the devices; gather totals.

        Latency is the **max** over per-device results (devices serve
        their sub-commands concurrently — the gather-barrier rule, §6.2);
        energy and access counters are sums. Window recording lands on
        each device's own engine (device-local online windows).
        """
        dev, ltab, lrow = self.plan.route(tables, rows)
        out = SimResult()
        latency = 0.0
        for d, eng in enumerate(self.devices):
            sel = dev == d
            if not sel.any():
                continue
            r = eng.serve(ltab[sel], lrow[sel], record_window=record_window,
                          window=window, force_exact=force_exact)
            out = out.merge(r)
            latency = max(latency, r.latency_us)
        out.latency_us = latency
        return out

    def maybe_remap(self, day: int,
                    trigger: ThresholdTrigger | PeriodTrigger
                    ) -> DayLog | None:
        """Device-local end-of-day trigger pass (§6.3).

        Each device evaluates the trigger on its *own* window counts and
        pays only its own rewrite. Fired devices rewrite concurrently, so
        the merged lump-sum latency is the max over devices while energy
        and update-report counters sum. Returns ``None`` when no device
        fired.
        """
        fired = [log for log in (eng.maybe_remap(day, trigger)
                                 for eng in self.devices) if log is not None]
        if not fired:
            return None
        merged = UpdateReport()
        for log in fired:
            if log.update_report is not None:
                merged += log.update_report
        return DayLog(day=day, inference=SimResult(), triggered=True,
                      remap_latency_us=max(f.remap_latency_us for f in fired),
                      remap_energy_uj=sum(f.remap_energy_uj for f in fired),
                      update_report=merged)
