"""Deployment API v2 — one declarative config, one facade (DESIGN.md §3).

``DeploymentConfig`` captures everything a serving deployment needs —
tables, flash part, policy set, cache, batcher, trigger, hot fraction,
sampling seed, channel count, device count + shard strategy (multi-SSD
scale-out, DESIGN.md §6) — as a serializable dataclass
(``to_dict``/``from_dict`` round-trip through JSON), with ``from_arch``
constructors that pull shapes from the architecture registry (dlrm_rm2,
dlrm_mlperf, rmc1/2/3, dlrm_small).

``Deployment`` is the single construction path for every driver, benchmark
and example: it runs the offline phase (paper Fig. 8: sampled training
sweep -> per-table ``AccessStats`` -> frequency-based mapping) once, builds
one ``RecFlashEngine`` per policy, and exposes

* ``stream(...)``       — materialise an open-loop request stream,
                          optionally drifting (``DriftScenario``, §5.2),
* ``run_stream(...)``   — replay it through every policy lane
                          (``n_channels`` concurrent SLS servers per lane);
                          with a trigger + ``LiveRemapConfig`` the lane
                          remaps *in-band* mid-stream (DESIGN.md §5.3),
* ``step_day(...)``     — one day of the **bulk** online adaptive-remap
                          loop (Fig. 14 / Algorithm 1; see the
                          bulk-vs-live decision table, DESIGN.md §5.4),
* ``report()``          — per-policy tail-latency reports of the last run.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.configs import DLRMConfig, arch_shape
from repro_torch.core.engine import (SHARD_STRATEGIES, DayLog, RecFlashEngine,
                               ReplicationConfig, ShardedEngine, ShardPlan,
                               TableSpec)
from repro_torch.core.freq import AccessStats
from repro_torch.core.triggers import PeriodTrigger, ThresholdTrigger
from repro_torch.data.tracegen import generate_sls_batch
from repro_torch.flashsim.device import PARTS, CacheConfig, FaultConfig
from repro_torch.flashsim.timeline import POLICIES, SERVING_POLICIES, SimResult
from repro_torch.serving.batcher import BatcherConfig
from repro_torch.serving.host_cache import (HostCache, HostCacheBinding,
                                      HostCacheConfig)
from repro_torch.serving.metrics import LatencyReport
from repro_torch.serving.scheduler import (LaneTrace, LiveRemapConfig, replay,
                                     replay_sharded)
from repro_torch.serving.slo_scheduler import SLOConfig
from repro_torch.serving.workload import (ARRIVAL_PROCESSES, DriftScenario,
                                    Request, assign_slo_classes,
                                    diurnal_arrivals,
                                    make_drifting_requests, make_requests)

ARRIVALS = ARRIVAL_PROCESSES


@dataclasses.dataclass(frozen=True)
class TriggerConfig:
    """Serializable online-training trigger spec (paper §III-C3)."""

    kind: str = "threshold"         # threshold | period
    top_frac: float = 0.05
    portion: float = 0.001
    period_days: int = 1

    def __post_init__(self) -> None:
        if self.kind not in ("threshold", "period"):
            raise ValueError(f"unknown trigger kind {self.kind!r}")

    def build(self) -> ThresholdTrigger | PeriodTrigger:
        if self.kind == "threshold":
            return ThresholdTrigger(top_frac=self.top_frac,
                                    portion=self.portion)
        return PeriodTrigger(period_days=self.period_days)


def arch_model_config(cfg: "DeploymentConfig") -> DLRMConfig:
    """DLRMConfig for the compute half, consistent with ``cfg.tables``
    (uniform row count, deployment lookups) — requires ``cfg.arch``."""
    if not cfg.arch:
        raise ValueError("DeploymentConfig has no arch provenance; "
                         "construct it with DeploymentConfig.from_arch")
    base = arch_shape(cfg.arch)
    return dataclasses.replace(
        base, n_tables=len(cfg.tables),
        n_rows=tuple(t.n_rows for t in cfg.tables), lookups=cfg.lookups)


@dataclasses.dataclass
class DeploymentConfig:
    """Declarative serving-deployment spec; JSON-serializable."""

    tables: list[TableSpec]
    part: str = "TLC"
    policies: tuple = SERVING_POLICIES
    lookups: int = 20               # multi-hot width per table per request
    hot_frac: float = 0.05          # Algorithm-1 hot-region share
    k: float = 0.0                  # trace locality knob (paper §IV-A)
    seed: int = 0                   # sampling seed (offline phase: seed + 1)
    sample_inferences: int = 512    # offline-phase sampled training sweep
    # concurrent SLS servers per policy lane. Applies to the request-level
    # replay (run_stream); step_day serves each day's trace as one bulk
    # command on the engine simulator and is channel-count independent.
    n_channels: int = 1
    # multi-SSD scale-out (DESIGN.md §6): number of simulated SSDs per
    # lane and the shard strategy splitting the tables across them —
    # "table" (whole tables round-robined) or "row" (every table striped
    # over devices by hot rank). ``n_devices`` multiplies the channel
    # count: each device brings its own ``n_channels`` channels and its
    # own controller P$ SRAM. ``n_devices=1`` is the single-device lane,
    # bit-identical to the pre-scale-out path.
    n_devices: int = 1
    shard: str = "table"
    # per-SSD capacity in bytes, used to gate the *shard strategy*:
    # validation and ``from_arch`` check the largest single table
    # (table-wise) / its per-device row slice (row-wise) against it.
    # Deliberately not a bin-packing model — aggregate occupancy of a
    # device across tables is not enforced (DESIGN.md §6.1). None =
    # capacity not modeled, any table fits any device.
    device_bytes: int | None = None
    cache: CacheConfig | None = None
    batcher: BatcherConfig = dataclasses.field(default_factory=BatcherConfig)
    trigger: TriggerConfig | None = None
    # drift scenario for streams built via ``stream()`` (DESIGN.md §5.2);
    # None or kind='none' keeps the stationary path byte-identical.
    scenario: DriftScenario | None = None
    # in-band adaptive remapping for ``run_stream`` (DESIGN.md §5.3);
    # requires ``trigger``. None keeps the replay remap-free (step_day
    # remains the only consumer of the trigger, as before).
    live_remap: LiveRemapConfig | None = None
    # SLO-aware dispatch (DESIGN.md §7): priority classes, admission,
    # shed/degrade ladder. None keeps the legacy batcher path — no class
    # annotation on streams, replay bit-identical to the pre-SLO lane.
    # Mutually exclusive with live_remap (two mid-stream control loops).
    slo: SLOConfig | None = None
    # fault injection (DESIGN.md §9): seeded read-retry/bad-block/event
    # model threaded to every device simulator. None (or a config with
    # ``active`` False) keeps every lane byte-identical to the
    # fault-free path — no RNG is even constructed.
    fault: FaultConfig | None = None
    # replicated hot set + failover/hedging (DESIGN.md §9.2–§9.3).
    # Setting it forces the sharded scatter-gather replay even at
    # ``n_devices=1`` (replicas are extra devices behind the plan).
    replication: ReplicationConfig | None = None
    # host-DRAM cache tier above the device lanes (DESIGN.md §10):
    # frequency-informed admission, DRAM-latency hits, miss residues to
    # the devices. None keeps every replay path byte-identical to the
    # tier-free lane. Composes with everything (the tier sits above the
    # scatter, the SLO discipline, and the fault layer).
    host_cache: HostCacheConfig | None = None
    arch: str | None = None         # provenance (set by from_arch)

    def __post_init__(self) -> None:
        self.part = self.part.upper()
        if self.part not in PARTS:
            raise ValueError(f"unknown flash part {self.part!r}; "
                             f"have {sorted(PARTS)}")
        self.policies = tuple(self.policies)
        for pol in self.policies:
            if pol not in POLICIES:
                raise ValueError(f"unknown policy {pol!r}; "
                                 f"have {sorted(POLICIES)}")
        if not self.tables:
            raise ValueError("need at least one table")
        if self.n_channels < 1:
            raise ValueError("n_channels must be >= 1")
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if self.shard not in SHARD_STRATEGIES:
            raise ValueError(f"unknown shard strategy {self.shard!r}; "
                             f"have {SHARD_STRATEGIES}")
        if self.device_bytes is not None and self.device_bytes < 1:
            raise ValueError("device_bytes must be positive (or None)")
        if self.device_bytes is not None:
            if self.shard == "table" and any(
                    t.table_bytes > self.device_bytes for t in self.tables):
                raise ValueError(
                    "a table overflows device_bytes under table-wise "
                    "sharding; use shard='row' (from_arch picks it "
                    "automatically)")
            if self.shard == "row" and any(
                    -(-t.n_rows // self.n_devices) * t.vec_bytes
                    > self.device_bytes for t in self.tables):
                raise ValueError(
                    "a table's per-device row slice overflows device_bytes "
                    "even under row-wise sharding; increase n_devices")
        if self.live_remap is not None and self.trigger is None:
            raise ValueError("live_remap requires a trigger "
                             "(set TriggerConfig as well)")
        if self.slo is not None and self.live_remap is not None:
            raise ValueError("slo scheduling and live_remap do not "
                             "compose; configure one mid-stream loop")
        if self.replication is not None and self.live_remap is not None:
            raise ValueError("replication rides the sharded replay, which "
                             "does not compose with live_remap")

    # -- registry constructors ------------------------------------------------
    @classmethod
    def from_arch(cls, arch: str, part: str = "TLC",
                  n_tables: int | None = None, n_rows: int | None = None,
                  lookups: int | None = None, **overrides: Any
                  ) -> "DeploymentConfig":
        """Build a config from a registered architecture's shapes.

        Heterogeneous-vocab archs (dlrm_mlperf) are uniformised to the
        paper's 1M-rows-per-table serving convention unless ``n_rows``
        overrides it; ``n_tables``/``lookups`` override the arch shape.

        When ``device_bytes`` is given (per-SSD capacity) and no explicit
        ``shard`` override is, the shard strategy is picked automatically:
        row-wise iff a single table would overflow one device, table-wise
        otherwise (DESIGN.md §6.1).
        """
        shape = arch_shape(arch)
        if n_rows is None:
            vocabs = set(shape.n_rows)
            n_rows = (shape.n_rows[0] if len(vocabs) == 1
                      else min(1_000_000, max(vocabs)))
        n_tables = shape.n_tables if n_tables is None else n_tables
        tables = [TableSpec(n_rows, shape.embed_dim * 4)] * n_tables
        device_bytes = overrides.get("device_bytes")
        if "shard" not in overrides and device_bytes is not None:
            overrides["shard"] = ("row" if any(
                t.table_bytes > device_bytes for t in tables) else "table")
        return cls(tables=tables, part=part,
                   lookups=shape.lookups if lookups is None else lookups,
                   arch=arch.lower().replace("-", "_"), **overrides)

    # -- serialization --------------------------------------------------------
    def to_dict(self) -> dict:
        return dict(
            tables=[[t.n_rows, t.vec_bytes] for t in self.tables],
            part=self.part, policies=list(self.policies),
            lookups=self.lookups, hot_frac=self.hot_frac, k=self.k,
            seed=self.seed, sample_inferences=self.sample_inferences,
            n_channels=self.n_channels, n_devices=self.n_devices,
            shard=self.shard, device_bytes=self.device_bytes,
            cache=dataclasses.asdict(self.cache) if self.cache else None,
            batcher=dataclasses.asdict(self.batcher),
            trigger=dataclasses.asdict(self.trigger) if self.trigger
            else None,
            scenario=dataclasses.asdict(self.scenario) if self.scenario
            else None,
            live_remap=dataclasses.asdict(self.live_remap)
            if self.live_remap else None,
            slo=self.slo.to_dict() if self.slo else None,
            fault=self.fault.to_dict() if self.fault else None,
            replication=self.replication.to_dict() if self.replication
            else None,
            host_cache=self.host_cache.to_dict() if self.host_cache
            else None,
            arch=self.arch)

    @classmethod
    def from_dict(cls, d: dict) -> "DeploymentConfig":
        d = dict(d)
        d["tables"] = [TableSpec(int(n), int(v)) for n, v in d["tables"]]
        d["policies"] = tuple(d.get("policies", SERVING_POLICIES))
        if d.get("cache") is not None:
            d["cache"] = CacheConfig(**d["cache"])
        d["batcher"] = BatcherConfig(**d.get("batcher", {}))
        if d.get("trigger") is not None:
            d["trigger"] = TriggerConfig(**d["trigger"])
        if d.get("scenario") is not None:
            d["scenario"] = DriftScenario(**d["scenario"])
        if d.get("live_remap") is not None:
            d["live_remap"] = LiveRemapConfig(**d["live_remap"])
        if d.get("slo") is not None:
            d["slo"] = SLOConfig.from_dict(d["slo"])
        # legacy blobs predate fault/replication — absent keys mean None
        if d.get("fault") is not None:
            d["fault"] = FaultConfig.from_dict(d["fault"])
        else:
            d.pop("fault", None)
        if d.get("replication") is not None:
            d["replication"] = ReplicationConfig.from_dict(d["replication"])
        else:
            d.pop("replication", None)
        if d.get("host_cache") is not None:
            d["host_cache"] = HostCacheConfig.from_dict(d["host_cache"])
        else:
            d.pop("host_cache", None)
        return cls(**d)


@dataclasses.dataclass
class DayResult:
    """One policy lane's outcome for one day of the online loop."""

    policy: str
    inference: SimResult
    remap: DayLog | None = None


class Deployment:
    """One serving deployment: offline phase + per-policy engine lanes."""

    def __init__(self, cfg: DeploymentConfig,
                 sample_stats: list[AccessStats] | None = None,
                 host_cache: HostCache | None = None) -> None:
        """``host_cache`` shares an existing host-DRAM tier between
        deployments (DESIGN.md §10.3): pass the same ``HostCache`` to
        each and give every config's ``host_cache`` block its own
        ``quota``. With it None and a config block set, the deployment
        builds a private tier of ``cfg.host_cache.dram_bytes``."""
        self.cfg = cfg
        self.part = PARTS[cfg.part]
        n_tables = len(cfg.tables)
        if sample_stats is None:
            n_rows = cfg.tables[0].n_rows
            if any(t.n_rows != n_rows for t in cfg.tables):
                raise ValueError(
                    "sampled offline phase needs uniform table row counts; "
                    "pass explicit sample_stats for heterogeneous tables")
            # offline phase (Fig. 8): sampled training sweep -> access stats
            tb, rows = generate_sls_batch(n_tables, n_rows, cfg.lookups,
                                          cfg.sample_inferences, k=cfg.k,
                                          seed=cfg.seed + 1)
            sample_stats = [AccessStats.from_trace(rows[tb == t], n_rows)
                            for t in range(n_tables)]
        self.stats = sample_stats
        # host-DRAM tier (DESIGN.md §10): bind this model to the shared
        # tier (or a private one), frequency-informed admission derived
        # from the same sampled offline stats the mapping uses.
        self._cache_binding: HostCacheBinding | None = None
        self.host_cache: HostCache | None = None
        if cfg.host_cache is not None:
            tier = (host_cache if host_cache is not None
                    else HostCache(cfg.host_cache.dram_bytes))
            self.host_cache = tier
            self._cache_binding = tier.register(
                cfg.host_cache, list(cfg.tables), self.stats)
        elif host_cache is not None:
            raise ValueError("a shared HostCache was passed but the "
                             "config has no host_cache block")
        self.trigger = cfg.trigger.build() if cfg.trigger else None
        # n_devices == 1 keeps the plain single-device engine (and replay
        # path) so the pre-scale-out lane stays bit-identical; n > 1 builds
        # one ShardedEngine per policy — N devices, each with its own
        # simulator/window/hash-table state, sharing one ShardPlan derived
        # from the deployment stats (DESIGN.md §6).
        self.engines: dict[str, RecFlashEngine | ShardedEngine]
        fault = cfg.fault if (cfg.fault is not None
                              and cfg.fault.active) else None
        # replication rides the shard plan, so it forces the sharded
        # engine/replay even at n_devices=1 (DESIGN.md §9.2)
        self.sharded = cfg.n_devices > 1 or cfg.replication is not None
        if not self.sharded:
            self.engines = {
                pol: RecFlashEngine(list(cfg.tables), self.part, policy=pol,
                                    sample_stats=self.stats,
                                    hot_frac=cfg.hot_frac,
                                    cache_cfg=cfg.cache,
                                    fault=fault.for_device(0)
                                    if fault is not None else None)
                for pol in cfg.policies}
        else:
            plan = ShardPlan(list(cfg.tables), self.stats, cfg.n_devices,
                             cfg.shard, replication=cfg.replication)
            self.engines = {
                pol: ShardedEngine(list(cfg.tables), self.part, policy=pol,
                                   sample_stats=self.stats,
                                   hot_frac=cfg.hot_frac,
                                   cache_cfg=cfg.cache,
                                   n_devices=cfg.n_devices, shard=cfg.shard,
                                   plan=plan, fault=fault,
                                   replication=cfg.replication)
                for pol in cfg.policies}
        self.last_traces: dict[str, LaneTrace] | None = None

    def engine(self, policy: str) -> RecFlashEngine | ShardedEngine:
        return self.engines[policy]

    # -- request streams ------------------------------------------------------
    def stream(self, n_requests: int, rate_rps: float,
               arrival: str = "poisson", seed: int | None = None,
               arrival_seed: int | None = None,
               scenario: DriftScenario | None = None,
               **arrival_kw: Any) -> list[Request]:
        """Materialise an open-loop request stream matching the deployment's
        table shapes. ``seed`` defaults to the config seed; the arrival
        process draws from ``arrival_seed`` (default ``seed + 2``).

        ``scenario`` (default: the config's ``scenario``) makes the stream
        non-stationary (DESIGN.md §5.2): ``gradual``/``flash_crowd``
        rewrite the row stream on top of the base trace, ``diurnal``
        replaces the arrival process with the rate-modulated one. With no
        scenario (or kind ``'none'``) the stream is byte-identical to the
        stationary path.

        With a config ``slo`` block the stream is class-annotated from
        its ``mix`` (seed ``seed + 3``, positional draw — orthogonal to
        trace and arrival seeds, DESIGN.md §7.1); the accesses and
        arrivals themselves are untouched."""
        n_rows = self.cfg.tables[0].n_rows
        if any(t.n_rows != n_rows for t in self.cfg.tables):
            raise ValueError(
                "stream() draws from a uniform per-table vocab; build "
                "requests for heterogeneous tables with make_requests and "
                "a per-table generator instead")
        seed = self.cfg.seed if seed is None else seed
        arrival_seed = seed + 2 if arrival_seed is None else arrival_seed
        scenario = self.cfg.scenario if scenario is None else scenario
        if scenario is not None and scenario.kind == "diurnal":
            # the scenario owns the arrival process — reject a conflicting
            # explicit request rather than silently ignoring it
            if arrival not in ("poisson", "diurnal") or arrival_kw:
                raise ValueError(
                    "diurnal scenario replaces the arrival process; don't "
                    f"also pass arrival={arrival!r} / arrival kwargs "
                    f"{sorted(arrival_kw)}")
            ts = diurnal_arrivals(n_requests, rate_rps,
                                  amp=scenario.diurnal_amp,
                                  period_us=scenario.diurnal_period_us,
                                  seed=arrival_seed)
        else:
            ts = ARRIVALS[arrival](n_requests, rate_rps, seed=arrival_seed,
                                   **arrival_kw)
        if scenario is None or scenario.kind == "none":
            reqs = make_requests(n_requests, len(self.cfg.tables), n_rows,
                                 self.cfg.lookups, ts, k=self.cfg.k,
                                 seed=seed)
        else:
            reqs = make_drifting_requests(n_requests, len(self.cfg.tables),
                                          n_rows, self.cfg.lookups, ts,
                                          scenario, k=self.cfg.k, seed=seed)
        if self.cfg.slo is not None:
            assign_slo_classes(reqs, self.cfg.slo.mix, seed=seed + 3)
        return reqs

    # -- serving --------------------------------------------------------------
    def run_stream(self, requests: list[Request],
                   record_window: bool = False,
                   batcher: BatcherConfig | None = None,
                   n_channels: int | None = None,
                   live: LiveRemapConfig | None = None,
                   slo: SLOConfig | None = None
                   ) -> dict[str, LaneTrace]:
        """Replay the stream through every policy lane; {policy: LaneTrace}.

        ``batcher``/``n_channels`` override the config for one run (the
        benchmarks sweep batcher points against one shared deployment).
        ``n_channels`` applies *here* and not to :meth:`step_day`, which
        serves each day as one bulk command on the engine's own simulator
        and is channel-count independent (see its docstring) — channel
        concurrency is a property of the request-level replay.

        ``live`` (default: the config's ``live_remap``) arms the in-band
        adaptive-remap loop on the remapping lanes (DESIGN.md §5.3): the
        deployment trigger is evaluated mid-stream at window boundaries
        and firing rewrites are charged as page-program traffic that
        competes with the queued reads. Baseline lanes never remap either
        way (paper §III-C4). With ``live`` unset the replay is remap-free
        and bit-identical to the pre-live path even when a trigger is
        configured.

        With ``n_devices > 1`` the replay is the scatter-gather dispatch
        over the deployment's shard plan (DESIGN.md §6.2): every device
        runs its own batcher/channels/remap loop over its sub-stream and a
        request completes at the max of its device completions. Live remap
        is then device-local — each device's trigger sees only its own
        window counts (§6.3).

        ``slo`` (default: the config's ``slo``) switches every lane to
        the SLO-aware dispatch discipline (DESIGN.md §7); with it unset
        the replay is the legacy batcher path, bit-identical to pre-SLO
        output. SLO and live remap do not compose."""
        batcher = self.cfg.batcher if batcher is None else batcher
        nc = self.cfg.n_channels if n_channels is None else n_channels
        live = self.cfg.live_remap if live is None else live
        slo = self.cfg.slo if slo is None else slo
        if slo is not None and live is not None:
            raise ValueError("slo scheduling and live remap do not "
                             "compose; configure one mid-stream loop")
        trig = self.trigger if live is not None else None
        run = (replay_sharded if self.sharded else replay)
        traces = {pol: run(requests, eng, batcher,
                           record_window=record_window, policy_name=pol,
                           n_channels=nc, trigger=trig, live=live, slo=slo,
                           host_cache=self._cache_binding)
                  for pol, eng in self.engines.items()}
        self.last_traces = traces
        return traces

    def report(self) -> dict[str, LatencyReport]:
        """Per-policy LatencyReport of the most recent ``run_stream``."""
        if self.last_traces is None:
            raise RuntimeError("no stream replayed yet; call run_stream()")
        return {pol: tr.report for pol, tr in self.last_traces.items()}

    # -- online adaptive remap (Fig. 14 / Algorithm 1) ------------------------
    def step_day(self, day: int, tables: np.ndarray,
                 rows: np.ndarray) -> dict[str, DayResult]:
        """Serve one day of traffic on every lane, then evaluate the
        deployment trigger and charge the adaptive-remap cost where it
        fires. Baseline lanes serve without window recording and never
        remap (paper §III-C4: both systems redeploy whole tables as part of
        the normal pipeline, so neither is charged).

        The day's trace is served as one bulk command on the engine's own
        simulator — ``n_channels`` deliberately does not apply here (it is
        a property of the request-level replay; use ``run_stream`` to study
        channel concurrency under arrivals)."""
        out = {}
        for pol, eng in self.engines.items():
            record = (self.trigger is not None
                      and eng.policy.mapping_mode != "baseline")
            res = eng.serve(tables, rows, record_window=record)
            log = (eng.maybe_remap(day, self.trigger)
                   if self.trigger is not None else None)
            out[pol] = DayResult(policy=pol, inference=res, remap=log)
        return out
