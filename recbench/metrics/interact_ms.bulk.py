"""interact_ms.bulk: device milliseconds per step of every operation
launched inside the ``dlrm.interact`` span in the traced window: the fused
interaction kernel and the bags' cast to its dtype, where there is one
(``recbench/spans.py`` pairs launches with operations)."""

from recbench import spans


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    s = spans.device_s(t, (spans.INTERACT,))
    return None if s is None else 1e3 * s / t.steps
