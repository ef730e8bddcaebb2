"""The program's spans in a traced window, and the device operations each one
launched: what the span readers (``metrics/*.py``) share.

The port marks its DLRM step with host spans in the profiler's trace
(``repro_torch.obs``): ``dlrm.forward`` around each call and, inside it, its
four layers. Their names are written out here, not imported, so that a
reader run over a program without spans finds none and reads nothing.

A device operation belongs to the innermost span that contains the host
event that launched it. Launches and operations are paired one to one, each
list in order of start, since the step runs on one stream: the n-th launch
started the n-th operation. Where the window holds a different number of
each, nothing is attributed.
"""

from __future__ import annotations

import numpy as np

FORWARD = "dlrm.forward"
BOT_MLP = "dlrm.bot_mlp"
BAGS = "dlrm.bags"
INTERACT = "dlrm.interact"
TOP_MLP = "dlrm.top_mlp"
CHILDREN = (BOT_MLP, BAGS, INTERACT, TOP_MLP)

# host events that put one operation on the device's stream: kernels
# (the CUDA runtime API's and the low-level cu* API's; cuBLAS uses both),
# copies, sets
LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"})


def _rows(events) -> np.ndarray:
    """(name, start, end) events as (k, 2) rows of [start, end) ns."""
    return np.array([(s, e) for _, s, e in events],
                    dtype=np.int64).reshape(-1, 2)


def _inside(rows: np.ndarray, t: np.ndarray) -> np.ndarray:
    """For each time in ``t``, the row of disjoint ``rows`` that holds it,
    or -1."""
    if not len(rows):
        return np.full(t.shape, -1)
    i = np.searchsorted(rows[:, 0], t, side="right") - 1
    hit = (i >= 0) & (t < rows[np.maximum(i, 0), 1])
    return np.where(hit, i, -1)


def owners(trace) -> list | None:
    """For each device operation of ``trace`` (in its order), the name of
    the innermost span that launched it, or None for one launched outside
    every span. None where the trace has no operation, no ``FORWARD``
    span, or not as many launches as operations."""
    if not trace.n_ops:
        return None
    fwd = _rows(h for h in trace.host if h[0] == FORWARD)
    if not len(fwd):
        return None
    starts = np.array([s for n, s, _ in trace.host if n in LAUNCHES],
                      dtype=np.int64)
    if starts.size != trace.n_ops:
        return None
    # operations in order of start; launches are already (host is sorted)
    order = np.argsort(trace.starts, kind="stable")
    kids = [h for h in trace.host if h[0] in CHILDREN]
    in_fwd = _inside(fwd, starts) >= 0
    in_kid = _inside(_rows(kids), starts)
    out: list = [None] * trace.n_ops
    for k, op in enumerate(order.tolist()):
        if in_kid[k] >= 0:
            out[op] = kids[in_kid[k]][0]
        elif in_fwd[k]:
            out[op] = FORWARD
    return out


def device_s(trace, names) -> float | None:
    """Device seconds of the operations launched inside the spans
    ``names`` (innermost), or None where ``owners`` finds nothing."""
    own = owners(trace)
    if own is None:
        return None
    names = set(names)
    return sum(int(e - s) for o, s, e in zip(own, trace.starts, trace.ends,
                                             strict=True)
               if o in names) * 1e-9

