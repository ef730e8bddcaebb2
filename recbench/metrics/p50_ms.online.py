"""p50_ms.online: the median latency of every request due in the measured
window, from its scheduled arrival to its logits on the host (the window's
own latencies, also in a traced run)."""

from recbench.arith import percentiles


def read(run):
    if run.latencies_ms is None:
        return None
    return percentiles(run.latencies_ms, (50.0,))[0]
