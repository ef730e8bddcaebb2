"""Serving subsystem: declarative `Deployment` facade over request queue +
dynamic batcher + multi-channel policy lanes (DESIGN.md §3), with the
SLO-aware dispatch discipline layered on top (DESIGN.md §7)."""

from repro_torch.core.engine import ReplicationConfig
from repro_torch.flashsim.device import FaultConfig, FaultEvent
from repro_torch.flashsim.timeline import SERVING_POLICIES
from repro_torch.serving.batcher import Batch, BatcherConfig, DynamicBatcher
from repro_torch.serving.deployment import (DayResult, Deployment,
                                      DeploymentConfig, TriggerConfig,
                                      arch_model_config)
from repro_torch.serving.host_cache import (HostCache, HostCacheBinding,
                                      HostCacheConfig)
from repro_torch.serving.metrics import (LatencyReport, percentiles, summarize,
                                   summarize_classes, tail_timeseries)
from repro_torch.serving.queueing import RequestQueue
from repro_torch.serving.scheduler import (LaneTrace, LiveRemapConfig, RemapEvent,
                                     ServingScheduler, build_policy_engines,
                                     replay, replay_sharded)
from repro_torch.serving.slo_scheduler import (SLOConfig, SLOEvent, hot_row_mask,
                                         slo_replay)
from repro_torch.serving.workload import (SLO_CLASSES, DriftScenario, Request,
                                    assign_slo_classes, bursty_arrivals,
                                    diurnal_arrivals, make_drifting_requests,
                                    make_requests, poisson_arrivals)

__all__ = [
    "FaultConfig", "FaultEvent", "ReplicationConfig",
    "Batch", "BatcherConfig", "DynamicBatcher",
    "DayResult", "Deployment", "DeploymentConfig", "TriggerConfig",
    "arch_model_config",
    "HostCache", "HostCacheBinding", "HostCacheConfig",
    "LatencyReport", "percentiles", "summarize", "summarize_classes",
    "tail_timeseries",
    "RequestQueue", "SERVING_POLICIES",
    "LaneTrace", "LiveRemapConfig", "RemapEvent", "ServingScheduler",
    "build_policy_engines", "replay", "replay_sharded",
    "SLOConfig", "SLOEvent", "hot_row_mask", "slo_replay",
    "SLO_CLASSES", "DriftScenario", "Request", "assign_slo_classes",
    "bursty_arrivals", "diurnal_arrivals", "make_drifting_requests",
    "make_requests", "poisson_arrivals",
]
