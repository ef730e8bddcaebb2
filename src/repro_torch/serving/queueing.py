"""Arrival-ordered request queue with simulated-clock visibility (DESIGN.md §3.2).

The queue holds the *entire* (possibly out-of-order-pushed) request stream
but only releases requests whose arrival timestamp is <= the simulated
clock the caller passes in — the scheduler never sees the future. Pops are
strictly arrival-ordered (FIFO in arrival time, rid as tiebreak), which is
what makes per-request latency accounting well-defined under bursty
arrivals.

Implementation: a lazily-sorted array with a pop cursor. Streams are
pushed up front and drained in order, so ``peek``/``arrival_of_kth``/
``pop_arrived`` are O(1) amortised per request — no per-batch heap scans —
while out-of-order pushes just mark the tail for re-sorting.
"""

from __future__ import annotations

from collections.abc import Iterable

from repro_torch.serving.workload import Request


class RequestQueue:
    """Arrival-ordered queue with arrival-time-gated pops."""

    def __init__(self, requests: Iterable[Request] = ()) -> None:
        self._items: list[Request] = list(requests)
        self._cursor = 0
        self._sorted = False

    def _ensure_sorted(self) -> None:
        if not self._sorted:
            tail = self._items[self._cursor:]
            tail.sort(key=lambda r: (r.arrival_us, r.rid))
            self._items[self._cursor:] = tail
            self._sorted = True

    def __len__(self) -> int:
        return len(self._items) - self._cursor

    def push(self, req: Request) -> None:
        self._items.append(req)
        self._sorted = False

    def peek(self) -> Request | None:
        """Earliest pending request regardless of the clock (None if empty)."""
        if not len(self):
            return None
        self._ensure_sorted()
        return self._items[self._cursor]

    def arrival_of_kth(self, k: int) -> float:
        """Arrival time of the k-th earliest pending request (1-based).

        ``inf`` when fewer than ``k`` requests remain — the batcher uses
        this as "when would the batch fill?".
        """
        if k <= 0:
            raise ValueError("k is 1-based")
        if k > len(self):
            return float("inf")
        self._ensure_sorted()
        return self._items[self._cursor + k - 1].arrival_us

    def pop_arrived(self, now_us: float, limit: int | None = None
                    ) -> list[Request]:
        """Pop up to ``limit`` requests with ``arrival_us <= now_us``,
        in arrival order."""
        self._ensure_sorted()
        out: list[Request] = []
        while self._cursor < len(self._items) \
                and self._items[self._cursor].arrival_us <= now_us \
                and (limit is None or len(out) < limit):
            out.append(self._items[self._cursor])
            self._cursor += 1
        return out
