"""sls_roofline: the grouped SLS kernel's share of its roofline in the
traced window: the bound of each step's launch (the larger of its bytes at
3.35 TB/s and its adds at 67 TFLOP/s, the kernel adding in float32; bytes
and adds of a pool entry by the cell's model, ``Model.sls_work``, from
``arith.sls_bytes``) over the kernel's device time."""

import numpy as np

from recbench import arith


def read(run):
    t = run.trace
    if t is None or run.mode != "bulk":
        return None
    kernel_s = t.seconds(lambda n: "sls_kernel" in n)
    if kernel_s <= 0:
        return None
    model = run.cell.model
    bound = 0.0
    for e in np.nonzero(t.pool_uses)[0]:
        b, _ = arith.bound_s(*model.sls_work(run.pool_indices[e]))
        bound += float(t.pool_uses[e]) * b
    return 100.0 * bound / kernel_s
