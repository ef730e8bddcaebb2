"""Spans of the port's DLRM step, for a torch profiler's trace.

``span(name)`` marks a range of host time under ``name`` while a torch
profiler records (the harness's traced window, say); otherwise it is one
shared context manager that does nothing, at the cost of one check. There is
no switch of its own: tracing is on exactly when a profiler is on.

A span is a kineto ``cpu_op`` range (``torch._C._profiler.
_RecordFunctionFast``), not ``torch.profiler.record_function``. The latter
is a user annotation, and for each one that encloses a launch kineto adds a
CUDA-typed ``gpu_user_annotation`` event to the device's activity, which a
reader of the trace that counts device operations, or takes the union of
their intervals as the device's busy time, would count as work on the
device. A ``cpu_op`` adds nothing there. Its timestamps are on the clock of
the trace's device activity, so a reader can place each launch, and through
it each device operation, inside the span that launched it.

Spans nest by containment on the thread: a child lies inside its parent's
interval in the trace, so no ids are kept. ``models.dlrm.forward`` opens
``FORWARD`` around each call and, inside it in this order, ``BOT_MLP``,
``BAGS``, ``INTERACT`` and ``TOP_MLP``.
"""

from __future__ import annotations

import contextlib

import torch

FORWARD = "dlrm.forward"
BOT_MLP = "dlrm.bot_mlp"
BAGS = "dlrm.bags"
INTERACT = "dlrm.interact"
TOP_MLP = "dlrm.top_mlp"
CHILDREN = (BOT_MLP, BAGS, INTERACT, TOP_MLP)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks its body as the span ``name`` in the
    profiler's trace, or the shared no-op when no profiler records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
