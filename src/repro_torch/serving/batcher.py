"""Dynamic batcher — max-batch-size / max-wait SLS coalescing (DESIGN.md §3.2).

Incoming requests are merged into one large SLS command before hitting the
device. This is where the serving layer earns RecFlash its win: the FTL
coalesces the *whole* batched command by (plane, page), so co-batched
requests that touch the same hot pages share page reads — the baselines
(serial, arrival-order access) gain nothing from batching.

Dispatch rule (the standard inference-server contract):

  dispatch = max(device_free, min(head_arrival + max_wait_us, fill_time))

where ``fill_time`` is when the ``max_batch``-th request would arrive. A
batch therefore leaves when it is full, when its oldest request has waited
``max_wait_us``, or — under backlog — the moment the device frees up
(whatever has accumulated goes out, up to ``max_batch``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.queueing import RequestQueue
from repro_torch.serving.workload import Request


@dataclasses.dataclass
class Batch:
    """A coalesced SLS command formed from one or more requests."""

    requests: list[Request]
    tables: np.ndarray         # concatenated access stream
    rows: np.ndarray
    dispatch_us: float         # simulated time the batch left the batcher

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def n_lookups(self) -> int:
        return int(self.rows.size)


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_batch: int = 64        # requests per batch (coalescing upper bound)
    max_wait_us: float = 500.0  # oldest request's batching-delay budget

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait_us < 0:
            raise ValueError("max_wait_us must be >= 0")


class DynamicBatcher:
    """Forms batches from a RequestQueue against a simulated clock."""

    def __init__(self, cfg: BatcherConfig | None = None) -> None:
        self.cfg = cfg or BatcherConfig()

    def next_span(self, arrivals: np.ndarray, pos: int,
                  device_free_us: float = 0.0,
                  max_batch: int | None = None,
                  max_wait_us: float | None = None) -> tuple[int, float]:
        """Array form of :meth:`next_batch` for the replay hot loop.

        ``arrivals`` is the whole stream's arrival-sorted timestamp array
        and ``pos`` the first unserved position; returns ``(end,
        dispatch_us)`` so the next batch is positions ``[pos, end)``. Same
        dispatch rule and admission (arrival <= dispatch, up to
        ``max_batch``) as the queue-based path, with no per-request work.

        ``max_batch``/``max_wait_us`` override the config for this one
        call — the SLO lane feeds each priority class's own arrival-sorted
        queue through here with per-class limits (a latency-critical queue
        runs with zero batching delay, a bulk queue with a preemption-
        boundary size cap; DESIGN.md §7.2) without rebuilding batchers.
        """
        cfg = self.cfg
        mb = cfg.max_batch if max_batch is None else max_batch
        mw = cfg.max_wait_us if max_wait_us is None else max_wait_us
        head = float(arrivals[pos])
        fill = (float(arrivals[pos + mb - 1])
                if pos + mb <= arrivals.size else float("inf"))
        dispatch = max(head, device_free_us, min(head + mw, fill))
        end = pos + int(np.searchsorted(arrivals[pos:pos + mb],
                                        dispatch, side="right"))
        return end, dispatch

    def next_batch(self, queue: RequestQueue,
                   device_free_us: float = 0.0) -> Batch | None:
        """Form the next batch, or None if the queue is empty.

        ``device_free_us`` is when the downstream device can next accept
        work; waiting past it is free (the device was busy anyway), so the
        batcher keeps admitting arrivals until then.
        """
        head = queue.peek()
        if head is None:
            return None
        cfg = self.cfg
        deadline = head.arrival_us + cfg.max_wait_us
        fill_time = queue.arrival_of_kth(cfg.max_batch)
        dispatch = max(head.arrival_us, device_free_us,
                       min(deadline, fill_time))
        reqs = queue.pop_arrived(dispatch, limit=cfg.max_batch)
        # single vectorised concatenation — one np.concatenate over the
        # per-request views, no per-access python loop.
        tables = np.concatenate([r.tables for r in reqs])
        rows = np.concatenate([r.rows for r in reqs])
        return Batch(requests=reqs, tables=tables, rows=rows,
                     dispatch_us=dispatch)
