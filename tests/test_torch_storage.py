"""The port's storage half against the reference, on the CPU.

``repro_torch.{core,flashsim,serving}`` are numpy copies of the reference's
modules, so every comparison here is exact: the same inputs, made from a
seed with numpy, go through both packages and each field of each result
must be equal (NaN equal to NaN). Cases stay small (dlrm_small, at most
2000 rows per table, at most 200 requests).
"""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.engine as r_engine
import repro.core.freq as r_freq
import repro.core.remap as r_remap
import repro.flashsim.device as r_device
import repro.flashsim.timeline as r_timeline
import repro.serving as r_serving
import repro_torch.core.engine as t_engine
import repro_torch.core.freq as t_freq
import repro_torch.core.remap as t_remap
import repro_torch.flashsim.device as t_device
import repro_torch.flashsim.timeline as t_timeline
import repro_torch.serving as t_serving
from repro.data.tracegen import generate_sls_batch

NAMES = ("AccessStats", "CacheConfig", "FaultConfig", "FaultEvent", "PARTS",
         "POLICIES", "SLSSimulator", "TableSpec", "build_mapping",
         "build_mapping_from_order", "ReplicationConfig", "BatcherConfig",
         "Deployment", "DeploymentConfig", "TriggerConfig", "DriftScenario",
         "LiveRemapConfig", "SLOConfig", "HostCacheConfig")


def _namespace(*mods) -> SimpleNamespace:
    return SimpleNamespace(**{n: getattr(m, n) for n in NAMES for m in mods
                              if hasattr(m, n)})


REF = _namespace(r_freq, r_remap, r_device, r_timeline, r_engine, r_serving)
PORT = _namespace(t_freq, t_remap, t_device, t_timeline, t_engine, t_serving)
ARCHS = ("dlrm_small", "dlrm_rm2", "dlrm_mlperf", "rmc1", "rmc2", "rmc3")


def assert_same(got, want, path: str = "result") -> None:
    """Field-by-field exact equality of a port result and a reference one
    (classes matched by name; arrays by dtype and value, NaN equal to NaN)."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name),
                        f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert list(got) == list(want), path
        for key, w in want.items():
            assert_same(got[key], w, f"{path}[{key!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _stats(ns, n_tables=4, n_rows=2000, lookups=8, n=256, seed=51, k=0.0):
    tb, rows = generate_sls_batch(n_tables, n_rows, lookups, n, k=k,
                                  seed=seed)
    return [ns.AccessStats.from_trace(rows[tb == t], n_rows)
            for t in range(n_tables)]


# -- mappings and the simulator ----------------------------------------------

@pytest.mark.parametrize("mode", ["baseline", "af", "af_pd"])
def test_mappings_match(mode):
    want = [REF.build_mapping(2000, 256, 16384, 2, mode=mode, stats=s)
            for s in _stats(REF)]
    got = [PORT.build_mapping(2000, 256, 16384, 2, mode=mode, stats=s)
           for s in _stats(PORT)]
    assert_same(got, want)
    order = _stats(REF)[0].rank_order()[::-1].copy()
    assert_same(PORT.build_mapping_from_order(order, 128, 4096, 2, mode=mode),
                REF.build_mapping_from_order(order, 128, 4096, 2, mode=mode))


def _sim_run(ns, policy, part, cache, force_exact, fault=None):
    pol = ns.POLICIES[policy]
    mappings = [ns.build_mapping(2000, 128, ns.PARTS[part].page_bytes, 2,
                                 mode=pol.mapping_mode, stats=s)
                for s in _stats(ns)]
    cache_cfg = None if cache == "default" else ns.CacheConfig(
        sram_bytes=2 * ns.PARTS[part].page_bytes)
    fault_cfg = None if fault is None else ns.FaultConfig(**fault)
    sim = ns.SLSSimulator(ns.PARTS[part], pol, mappings,
                          cache_cfg=cache_cfg,
                          fault=None if fault_cfg is None
                          else fault_cfg.for_device(1), fault_stream=2)
    tb, rows = generate_sls_batch(4, 2000, 8, 96, k=0.3, seed=7)
    # per-request commands, then one whole-call command on the state the
    # first run left (buffers, cache)
    return [sim.run(tb, rows, window=32, force_exact=force_exact),
            sim.run(tb[::-1].copy(), rows[::-1].copy(),
                    force_exact=force_exact)]


@pytest.mark.parametrize("force_exact", [False, True])
@pytest.mark.parametrize("cache", ["default", "two-page"])
@pytest.mark.parametrize("part", ["SLC", "TLC", "QLC"])
@pytest.mark.parametrize("policy", list(r_timeline.POLICIES))
def test_simulator_runs_match(policy, part, cache, force_exact):
    assert_same(_sim_run(PORT, policy, part, cache, force_exact),
                _sim_run(REF, policy, part, cache, force_exact))


@pytest.mark.parametrize("policy", ["rmssd", "recflash"])
def test_simulator_fault_streams_match(policy):
    fault = dict(seed=5, read_fail_base=2e-3, bad_block_frac=0.02,
                 retention_age_days=30.0)
    want = _sim_run(REF, policy, "TLC", "default", False, fault)
    assert sum(r.n_retries for r in want) > 0
    assert_same(_sim_run(PORT, policy, "TLC", "default", False, fault), want)


# -- Deployment.run_stream over the reference's branches ----------------------

def _live(ns):
    return dict(hot_frac=0.05, sample_inferences=1024,
                trigger=ns.TriggerConfig("threshold", top_frac=0.05,
                                         portion=0.01),
                scenario=ns.DriftScenario(kind="gradual", shift_frac=0.05,
                                          ramp_end=0.3),
                live_remap=ns.LiveRemapConfig(window_us=1.5e4,
                                              chunk_pages=8))


def _fault(ns, n_devices=1):
    events = (ns.FaultEvent(t_us=2e4, kind="channel_stall", device=0,
                            duration_us=1e4),)
    if n_devices > 1:
        events += (ns.FaultEvent(t_us=4e4, kind="device_fail", device=1),)
    return ns.FaultConfig(seed=3, read_fail_base=2e-3, bad_block_frac=0.01,
                          events=events)


# name -> (overrides from a namespace, requests, rate, what the reference
# must show for the case to exercise its branch)
RUN_CASES = {
    "plain-1ch": (lambda ns: {}, 200, 20000.0, None),
    "plain-2ch": (lambda ns: dict(n_channels=2), 200, 20000.0, None),
    "sharded-table": (lambda ns: dict(n_devices=2, shard="table"), 200,
                      20000.0, lambda tr: tr.n_devices == 2),
    "sharded-row": (lambda ns: dict(n_devices=2, shard="row", n_channels=2),
                    200, 20000.0, lambda tr: tr.n_devices == 2),
    "replication": (lambda ns: dict(
        n_channels=2, replication=ns.ReplicationConfig(k=2, hot_frac=0.2,
                                                       hedge=True)),
        200, 20000.0, lambda tr: tr.report.n_hedged > 0),
    "live-remap": (_live, 200, 2000.0, lambda tr: bool(tr.remap_events)),
    "slo": (lambda ns: dict(slo=ns.SLOConfig(
        deadline_lc_us=2e3, deadline_std_us=1e4, deadline_bulk_us=3e4)),
        200, 20000.0, lambda tr: tr.report.n_shed + tr.report.n_degraded > 0),
    "fault": (lambda ns: dict(fault=_fault(ns)), 200, 4000.0,
              lambda tr: tr.report.n_retries > 0),
    "fault-failover": (lambda ns: dict(
        n_devices=2, shard="row", fault=_fault(ns, 2),
        replication=ns.ReplicationConfig(k=2, hot_frac=0.3)), 200, 4000.0,
        lambda tr: tr.report.n_failover + tr.report.n_failed > 0),
    "host-cache": (lambda ns: dict(host_cache=ns.HostCacheConfig(
        dram_bytes=1 << 20, policy="freq", admit_frac=0.5)), 200, 20000.0,
        lambda tr: tr.report.n_dram_hits > 0),
    "gradual": (lambda ns: dict(scenario=ns.DriftScenario(
        kind="gradual", shift_frac=0.05, ramp_end=0.5)), 200, 4000.0, None),
    "flash_crowd": (lambda ns: dict(scenario=ns.DriftScenario(
        kind="flash_crowd", spike_start=0.3, spike_len=0.3)), 200, 4000.0,
        None),
    "diurnal": (lambda ns: dict(scenario=ns.DriftScenario(kind="diurnal")),
                200, 4000.0, None),
}


def _run(ns, case, rows=2000, sample_stats=None):
    overrides, n, rate, _ = RUN_CASES[case]
    cfg = ns.DeploymentConfig.from_arch(
        "dlrm_small", n_rows=rows, seed=1,
        batcher=ns.BatcherConfig(max_batch=32, max_wait_us=500.0),
        **overrides(ns))
    dep = ns.Deployment(cfg, sample_stats=sample_stats)
    reqs = dep.stream(n, rate)
    return cfg, dep, reqs, dep.run_stream(reqs)


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_stream_matches(case):
    want_cfg, want_dep, want_reqs, want = _run(REF, case)
    got_cfg, got_dep, got_reqs, got = _run(PORT, case)
    exercised = RUN_CASES[case][3]
    if exercised is not None:
        assert exercised(want["recflash"]), f"{case} not exercised"
    assert got_cfg.to_dict() == want_cfg.to_dict()
    assert_same(got_dep.stats, want_dep.stats, "stats")
    assert_same(got_reqs, want_reqs, "stream")
    assert_same(got, want, "traces")
    assert_same(got_dep.report(), want_dep.report(), "report")


def test_lanes_match_on_given_stats():
    """The reference's stats handed to the port as numpy counts: the lanes
    are compared apart from the sampled sweep."""
    want_stats = _stats(REF, n_tables=8, n_rows=2000, lookups=20, seed=9,
                        k=0.8)
    port_stats = [PORT.AccessStats(s.counts.copy()) for s in want_stats]
    *_, want = _run(REF, "plain-2ch", sample_stats=want_stats)
    *_, got = _run(PORT, "plain-2ch", sample_stats=port_stats)
    assert_same(got, want, "traces")


# -- step_day ----------------------------------------------------------------

@pytest.mark.parametrize("trigger", [
    dict(kind="threshold", top_frac=0.05, portion=0.001),
    dict(kind="period", period_days=2),
])
def test_step_day_matches(trigger):
    def days(ns):
        dep = ns.Deployment(ns.DeploymentConfig.from_arch(
            "dlrm_small", n_rows=2000, seed=2,
            policies=tuple(r_timeline.POLICIES),
            trigger=ns.TriggerConfig(**trigger)))
        out = []
        for day in range(3):
            tb, rows = generate_sls_batch(8, 2000, 20, 256,
                                          k=(0.0, 0.3, 0.8)[day],
                                          seed=100 + day)
            out.append(dep.step_day(day, tb, rows))
        maps = {pol: eng.sim.mappings for pol, eng in dep.engines.items()}
        orders = {pol: [h.keys_in_order() for h in eng.hash_tables]
                  for pol, eng in dep.engines.items()}
        return out, maps, orders

    want = days(REF)
    assert any(r.remap is not None for day in want[0] for r in day.values())
    assert_same(days(PORT), want)


# -- DeploymentConfig ------------------------------------------------------------

# override block -> overrides from a namespace
BLOCKS = {
    "none": lambda ns: {},
    "shape": lambda ns: dict(n_tables=3, n_rows=4096, lookups=5,
                             part="qlc"),
    "knobs": lambda ns: dict(hot_frac=0.1, k=0.3, seed=4,
                             sample_inferences=64, n_channels=3,
                             policies=("rmssd", "recflash")),
    "devices": lambda ns: dict(n_devices=4, device_bytes=256 << 20),
    "shard": lambda ns: dict(n_devices=2, shard="row"),
    "cache": lambda ns: dict(cache=ns.CacheConfig(sram_bytes=64 * 1024)),
    "batcher": lambda ns: dict(batcher=ns.BatcherConfig(8, 50.0)),
    "trigger+live": lambda ns: dict(
        trigger=ns.TriggerConfig("period", period_days=3),
        live_remap=ns.LiveRemapConfig(window_us=1e5, chunk_pages=4)),
    "scenario": lambda ns: dict(scenario=ns.DriftScenario(
        kind="flash_crowd", spike_share=0.5)),
    "slo": lambda ns: dict(slo=ns.SLOConfig(mix=(0.3, 0.4, 0.3))),
    "fault+replication": lambda ns: dict(
        n_devices=2, fault=_fault(ns, 2),
        replication=ns.ReplicationConfig(k=3, part="SLC", hedge=True)),
    "host_cache": lambda ns: dict(host_cache=ns.HostCacheConfig(
        dram_bytes=1 << 16, policy="lru", quota=0.5)),
}


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_config_from_arch_matches(arch, block):
    want = REF.DeploymentConfig.from_arch(arch, **BLOCKS[block](REF))
    got = PORT.DeploymentConfig.from_arch(arch, **BLOCKS[block](PORT))
    assert got.to_dict() == want.to_dict()
    back = PORT.DeploymentConfig.from_dict(json.loads(json.dumps(
        want.to_dict())))
    assert_same(back, got)
    assert_same(t_serving.arch_model_config(got),
                r_serving.arch_model_config(want))


def test_config_legacy_blob_loads():
    d = REF.DeploymentConfig.from_arch("rmc1").to_dict()
    del d["fault"], d["replication"], d["host_cache"]
    assert_same(PORT.DeploymentConfig.from_dict(d),
                REF.DeploymentConfig.from_dict(d))
