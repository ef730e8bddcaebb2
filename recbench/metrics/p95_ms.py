"""p95_ms: the 95th percentile of the latency of every request due in the
window, from its scheduled arrival to its logits on the host."""

from recbench.arith import percentiles


def read(run):
    if run.latencies_ms is None:
        return None
    return percentiles(run.latencies_ms, (95.0,))[0]
