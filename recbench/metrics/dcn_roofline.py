"""dcn_roofline: the DLRM-DCN interaction arch's share of its roofline in
the traced window: the bound of the window's samples (the larger of the
cross network's FLOPs at 67 TFLOP/s, float32 off the tensor cores, and its
bytes at 3.35 TB/s; both a sample from the cell's model,
``Model.cross_work``) over the device seconds of every operation launched
inside the ``dlrm.interact`` span (the concatenation that forms x0 and the
cross network; ``recbench/spans.py`` pairs launches with operations).
None for a model without a cross network."""

from recbench import arith, spans


def read(run):
    t = run.trace
    work = getattr(run.cell.model, "cross_work", None)
    if t is None or work is None or run.mode != "bulk" or not t.steps:
        return None
    s = spans.device_s(t, (spans.INTERACT,))
    if not s:
        return None
    flops, n_bytes = work()
    samples = float(t.steps) * run.pool_indices.shape[1]
    bound, _ = arith.bound_s(n_bytes * samples, flops * samples)
    return 100.0 * bound / s
