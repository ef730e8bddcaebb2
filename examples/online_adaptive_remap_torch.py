"""Online-training simulation on the port: a week of serving with drift.

The counterpart of ``examples/online_adaptive_remap.py``; it imports no
JAX, only the port's numpy copies of the storage half and of the Criteo day
streams, and prints the same lines byte for byte.

The paper's Fig. 14 story in miniature — daily traffic drifts (new items
become hot), the threshold trigger (top-5%, 0.3% portion) watches the
online window, and when it fires the Algorithm-1 adaptive remap re-sorts
ONLY the hot region of the hash table and rewrites only those rows. One
``Deployment`` owns both policy lanes; ``step_day`` serves the day's
traffic and evaluates the trigger. Printed per day: serving latency,
whether training triggered, and the remap cost actually charged.

    PYTHONPATH=src python examples/online_adaptive_remap_torch.py
"""

from repro_torch.core.engine import TableSpec
from repro_torch.core.freq import AccessStats
from repro_torch.data.criteo import CriteoSpec, CriteoDayStream
from repro_torch.serving import Deployment, DeploymentConfig, TriggerConfig

N_DAYS = 7
N_ROWS = 100_000
DAILY = 2000           # inferences/day (scaled)

spec = CriteoSpec("demo", n_days=N_DAYS, rows_per_field=N_ROWS,
                  drift_frac=0.05)
stream = CriteoDayStream(spec, seed=0)

# offline phase: sample the training distribution, build the layout
counts = stream.sample_training_stats(20_000)
n_tables = 8
stats = [AccessStats(counts[t]) for t in range(n_tables)]

dep = Deployment(DeploymentConfig(
    tables=[TableSpec(N_ROWS, 128) for _ in range(n_tables)], part="TLC",
    policies=("rmssd", "recflash"), hot_frac=0.05,
    trigger=TriggerConfig("threshold", top_frac=0.05, portion=0.003)),
    sample_stats=stats)

print(f"{'day':>4} {'rmssd (ms)':>12} {'recflash (ms)':>14} "
      f"{'gain':>7} {'trained?':>9} {'remap cost (ms)':>16}")
cum_rf, cum_base = 0.0, 0.0
for day in range(N_DAYS):
    tb, rows, _ = stream.day_batch(day, DAILY)
    sel = tb < n_tables
    tb, rows = tb[sel], rows[sel]
    day_res = dep.step_day(day, tb, rows)
    r_base = day_res["rmssd"].inference
    r_rf = day_res["recflash"].inference
    log = day_res["recflash"].remap
    remap_ms = log.remap_latency_us / 1e3 if log else 0.0
    cum_base += r_base.latency_us / 1e3
    cum_rf += r_rf.latency_us / 1e3 + remap_ms
    print(f"{day:>4} {r_base.latency_us / 1e3:>12.1f} "
          f"{r_rf.latency_us / 1e3:>14.1f} "
          f"{1 - r_rf.latency_us / r_base.latency_us:>6.1%} "
          f"{'yes' if log else 'no':>9} {remap_ms:>16.2f}")
    if log:
        rep = log.update_report
        print(f"     -> adaptive remap: {rep.n_inserted_hot} new hot keys, "
              f"{rep.n_remapped} rows rewritten "
              f"({rep.n_remapped / (n_tables * N_ROWS):.2%} of the store), "
              f"{rep.n_comparisons} comparator ops")
    stream.advance_day()

print(f"\ncumulative: rmssd {cum_base:.1f} ms, recflash {cum_rf:.1f} ms "
      f"(incl. remap) -> {1 - cum_rf / cum_base:.1%} reduction")
