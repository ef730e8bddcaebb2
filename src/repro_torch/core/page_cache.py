"""Page-wise LRU cache (paper §III-C2, the ``P$`` of Fig. 5d).

A 128 KB SRAM in the SSD controller holds whole flash pages; lookups that hit
a cached page bypass the NAND array (no t_R). Replacement is page-granular
LRU. The structure is tiny (8 slots for 16 KB TLC pages, 32 for 4 KB SLC) so
an OrderedDict is exact and fast enough for per-access simulation — but the
serving stack streams millions of accesses, so the bulk path
(:func:`lru_hit_mask` / :meth:`PageLRU.bulk_access`) evaluates a whole access
stream at once via the classic reuse-distance (Mattson stack) result:

    an LRU cache of C slots hits an access iff the number of DISTINCT pages
    touched since the previous access to the same page is < C.

That count is computed offline in array form (prev-occurrence arrays plus a
bit-level trie pass standing in for a Fenwick tree, O(n log n) numpy with no
per-access Python), so the bulk path is exact — same hit mask, same final
cache state, same hit/miss counters as replaying :meth:`PageLRU.access` in a
loop (property-tested in ``tests/test_flashsim.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Sequence

import numpy as np


def _count_earlier_leq(vals: np.ndarray) -> np.ndarray:
    """``res[i] = #{j < i : vals[j] <= vals[i]}`` — O(n log n), vectorised.

    The textbook tool is a Fenwick tree updated access by access; that is
    inherently sequential, so instead the count is accumulated level by
    level over the bits of each element's value-rank (a binary indexed
    trie): a pair (j, i) with ``rank[j] < rank[i]`` is counted exactly once,
    at the level of the highest bit where the ranks differ. Each level is a
    stable grouping sort plus segmented cumulative sums — pure array ops.
    """
    n = vals.size
    res = np.zeros(n, dtype=np.int64)
    if n < 2:
        return res
    idx = np.arange(n, dtype=np.int64)
    # rank by (value, index): for j < i, vals[j] <= vals[i] iff
    # rank[j] < rank[i] (ties resolve toward the earlier index).
    order = np.lexsort((idx, vals))
    rank = np.empty(n, dtype=np.int64)
    rank[order] = idx
    for b in range(int(n - 1).bit_length()):
        g = rank >> (b + 1)                      # trie node at this level
        ordg = np.argsort(g, kind="stable")      # (node, time) order
        gs = g[ordg]
        one = (rank[ordg] >> b) & 1 == 1
        # zeros strictly before each position, then rebased per node
        zexc = np.cumsum(~one) - (~one)
        is_start = np.empty(n, dtype=bool)
        is_start[0] = True
        np.not_equal(gs[1:], gs[:-1], out=is_start[1:])
        start_of = np.maximum.accumulate(np.where(is_start, idx, 0))
        sel = one
        res[ordg[sel]] += zexc[sel] - zexc[start_of[sel]]
    return res


def lru_hit_mask(pages: np.ndarray, n_slots: int,
                 state: Sequence[int] = ()) -> tuple[np.ndarray, list]:
    """Exact LRU hit mask for a page access stream, fully vectorised.

    ``state`` is the resident-page sequence in LRU -> MRU order (at most
    ``n_slots`` distinct pages). Returns ``(hits, new_state)`` where
    ``hits[i]`` is True iff access ``i`` would hit a ``PageLRU(n_slots)``
    primed with ``state``, and ``new_state`` is the resident sequence
    afterwards — bit-identical to replaying :meth:`PageLRU.access`.

    Pipeline: (1) prime the stream with the carried state as virtual
    accesses into an empty cache; (2) collapse runs of equal pages (a run
    tail has reuse distance 0 — always a hit, never a state change);
    (3) per access, count distinct pages since its previous occurrence
    (``d[i] = #{k < i : prev[k] <= prev[i]} - (prev[i] + 1)``, the window
    members whose own previous occurrence predates the window are exactly
    its distinct pages); (4) hit iff ``prev >= 0 and d < n_slots``.
    """
    pages = np.asarray(pages, dtype=np.int64).ravel()
    n = pages.size
    prefix = np.asarray(tuple(state), dtype=np.int64)
    s = prefix.size
    if n == 0:
        return np.zeros(0, dtype=bool), prefix.tolist()
    seq = np.concatenate([prefix, pages]) if s else pages
    # (2) run collapse: only run heads can miss or move LRU state
    head = np.empty(seq.size, dtype=bool)
    head[0] = True
    np.not_equal(seq[1:], seq[:-1], out=head[1:])
    comp = seq[head]
    run_id = np.cumsum(head) - 1
    m = comp.size
    # (3) previous occurrence of each collapsed access
    idxm = np.arange(m, dtype=np.int64)
    order = np.lexsort((idxm, comp))
    sp = comp[order]
    prev = np.full(m, -1, dtype=np.int64)
    same = sp[1:] == sp[:-1]
    prev[order[1:][same]] = order[:-1][same]
    d = _count_earlier_leq(prev) - (prev + 1)
    hit_head = (prev >= 0) & (d < n_slots)
    # (4) expand back: run tails always hit; drop the virtual prefix
    hits = hit_head[run_id]
    hits[~head] = True
    hits = hits[s:]
    # new state = the n_slots most recently used distinct pages, LRU -> MRU
    # (LRU inclusion property; last occurrences sorted by time)
    is_last = np.empty(m, dtype=bool)
    is_last[-1] = True
    np.not_equal(sp[1:], sp[:-1], out=is_last[:-1])
    last_pos = np.sort(order[is_last])[-n_slots:]
    return hits, comp[last_pos].tolist()


class PageLRU:
    """Page-granular LRU with ``n_slots`` page frames."""

    def __init__(self, n_slots: int) -> None:
        if n_slots < 1:
            raise ValueError("cache needs at least one slot")
        self.n_slots = int(n_slots)
        self._slots: OrderedDict[int, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __contains__(self, page_id: int) -> bool:
        return page_id in self._slots

    def __len__(self) -> int:
        return len(self._slots)

    def access(self, page_id: int) -> bool:
        """Touch ``page_id``; returns True on hit. Miss inserts (LRU evict)."""
        if page_id in self._slots:
            self._slots.move_to_end(page_id)
            self.hits += 1
            return True
        self.misses += 1
        if len(self._slots) >= self.n_slots:
            self._slots.popitem(last=False)
        self._slots[page_id] = None
        return False

    def bulk_access(self, pages: np.ndarray) -> np.ndarray:
        """Touch a whole access stream at once; returns the per-access hit
        mask. Exactly equivalent (hits, final state, counters) to calling
        :meth:`access` per element, but vectorised via :func:`lru_hit_mask`.
        """
        hits, new_state = lru_hit_mask(pages, self.n_slots,
                                       state=self.residents())
        n_hits = int(hits.sum())
        self.hits += n_hits
        self.misses += int(hits.size) - n_hits
        self._slots = OrderedDict((p, None) for p in new_state)
        return hits

    def residents(self) -> list[int]:
        """Resident page ids in LRU -> MRU order."""
        return list(self._slots)

    def invalidate(self, page_id: int) -> None:
        self._slots.pop(page_id, None)

    def clear(self) -> None:
        self._slots.clear()

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0
