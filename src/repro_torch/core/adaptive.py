"""Algorithm 1 — access-frequency-based adaptive update of the hash table.

The inference mapping ("reference hash table", Fig. 6b) is a hash table whose
entries are threaded on a doubly linked list in descending access-frequency
order. The top-x% prefix is the **hot-item region**; its boundary entry is
the *threshold key* tau. After an online-training round, new keys are
inserted by scanning head..tau only: a key that beats a hot entry is spliced
in before it, the current tau is moved to the cold tail and the boundary
retracts by one (tau <- tau_prev) — so the hot-region size is invariant.
Keys that beat nobody are appended at the cold tail. Physical addresses are
then reassigned for the hot region only (Step 4); tail appends are assigned
directly; untouched cold keys keep their addresses.

Implementation note: we model the linked list with a sorted hot prefix +
append-ordered cold tail. This is behaviourally identical to the pointer
structure (the list *is* sorted, so splice position == sorted position) but
lets the simulator run million-row tables. The hardware cost model is kept
exact: ``n_comparisons`` counts the comparator invocations of the *linear*
head..tau scan the RTL performs, and ``n_pointer_updates`` counts the
doubly-linked-list pointer writes of each splice.
"""

from __future__ import annotations

import bisect
import dataclasses


@dataclasses.dataclass
class UpdateReport:
    """Cost accounting for one Algorithm-1 pass."""

    n_inserted_hot: int = 0       # new keys spliced into the hot region
    n_appended_tail: int = 0      # new keys appended cold
    n_comparisons: int = 0        # comparator invocations (linear-scan model)
    n_pointer_updates: int = 0    # doubly-linked-list pointer writes
    n_remapped: int = 0           # hot-region rows physically rewritten
    n_direct_assigned: int = 0    # tail rows written fresh (no remap)

    def __iadd__(self, other: "UpdateReport") -> "UpdateReport":
        """Accumulate another pass's counts (every field is additive)."""
        for f in dataclasses.fields(UpdateReport):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self


class AdaptiveHashTable:
    """Frequency-ordered mapping with hot-region-bounded updates (Alg. 1)."""

    def __init__(self, keys: np.ndarray, freqs: np.ndarray,
                 addrs: np.ndarray, hot_frac: float) -> None:
        """Entries must arrive frequency-descending (the offline sort)."""
        if not 0.0 < hot_frac <= 1.0:
            raise ValueError("hot_frac must be in (0, 1]")
        n = len(keys)
        if n == 0:
            raise ValueError("empty table")
        self.hot_frac = float(hot_frac)
        self._hot_size = max(1, int(round(n * hot_frac)))
        self._freq: dict[int, int] = {}
        self._addr: dict[int, int] = {}
        order = []
        last = None
        for k, f, a in zip(keys, freqs, addrs, strict=True):
            k, f = int(k), int(f)
            if last is not None and f > last:
                raise ValueError("initial entries must be freq-descending")
            last = f
            self._freq[k] = f
            self._addr[k] = int(a)
            order.append(k)
        # hot prefix kept sorted desc; cold tail keeps arrival order.
        self._hot: list[int] = order[: self._hot_size]
        self._neg_hot_freqs: list[int] = [-self._freq[k] for k in self._hot]
        self._cold: list[int] = order[self._hot_size:]
        self._cold_pos: dict[int, int] = {k: i for i, k in enumerate(self._cold)}

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._freq)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._freq

    @property
    def hot_size(self) -> int:
        return self._hot_size

    @property
    def threshold_key(self) -> int:
        return self._hot[-1]

    @property
    def threshold_freq(self) -> int:
        return self._freq[self._hot[-1]]

    def hot_keys(self) -> list[int]:
        return list(self._hot)

    def keys_in_order(self) -> list[int]:
        return self._hot + [k for k in self._cold if k is not None]

    def freq_of(self, key: int) -> int:
        return self._freq[int(key)]

    def addr_of(self, key: int) -> int:
        return self._addr[int(key)]

    # -- Algorithm 1 ---------------------------------------------------------
    def update(self, trained: dict[int, int]) -> UpdateReport:
        """Insert keys from one online-training window; reassign addresses.

        ``trained`` maps key -> access count observed in the window (the
        online-training hash table, Fig. 6a). Counts accumulate onto any
        existing entry. Returns the hardware cost report.
        """
        report = UpdateReport()
        # Hardware consumes the training table in sorted order.
        for key, freq in sorted(trained.items(), key=lambda kv: (-kv[1], kv[0])):
            key, freq = int(key), int(freq)
            existed_cold = existed_hot = False
            if key in self._freq:
                if key in self._cold_pos:
                    # splice the cold node out (2 pointer writes)
                    self._cold[self._cold_pos.pop(key)] = None
                    report.n_pointer_updates += 2
                    existed_cold = True
                else:
                    i = self._hot_index(key)
                    del self._hot[i]
                    del self._neg_hot_freqs[i]
                    report.n_pointer_updates += 2
                    existed_hot = True
                self._freq[key] += freq
            else:
                self._freq[key] = freq
                self._addr[key] = -1
            f_total = self._freq[key]

            if existed_hot:
                # in-hot reorder: hot size unchanged, no tau displacement.
                pos = bisect.bisect_left(self._neg_hot_freqs, -f_total)
                report.n_comparisons += pos + 1
                self._hot.insert(pos, key)
                self._neg_hot_freqs.insert(pos, -f_total)
                report.n_pointer_updates += 3
                continue

            # Step 3 — scan head..tau; splice in before first entry we beat.
            tau_freq = self._freq[self._hot[-1]]
            if f_total > tau_freq:
                pos = bisect.bisect_left(self._neg_hot_freqs, -f_total)
                report.n_comparisons += pos + 1
                self._hot.insert(pos, key)
                self._neg_hot_freqs.insert(pos, -f_total)
                report.n_pointer_updates += 3
                # displace tau to the cold tail; boundary retracts by one.
                tau = self._hot.pop()
                self._neg_hot_freqs.pop()
                self._cold_pos[tau] = len(self._cold)
                self._cold.append(tau)
                # retired hot item is physically rewritten into free space in
                # the cold region (paper §III-C4) — needs a fresh address.
                self._addr[tau] = -1
                report.n_pointer_updates += 5  # splice-out (2) + tail append (3)
                report.n_inserted_hot += 1
            else:
                # full scan reached tau without a hit.
                report.n_comparisons += self._hot_size
                self._cold_pos[key] = len(self._cold)
                self._cold.append(key)
                report.n_pointer_updates += 3
                if not existed_cold:
                    report.n_appended_tail += 1

        # Step 4 — address reassignment.
        for pos, key in enumerate(self._hot):
            self._addr[key] = pos            # hot region: physically remapped
            report.n_remapped += 1
        next_free = len(self._freq) - 1
        used = set(a for a in self._addr.values() if a >= 0)
        for key in self._cold:
            if key is None:
                continue
            if self._addr[key] < 0:          # fresh cold key: direct assign
                while next_free in used:
                    next_free -= 1
                self._addr[key] = next_free
                used.add(next_free)
                report.n_direct_assigned += 1
            # else: unchanged cold key keeps its physical address.
        return report

    def _hot_index(self, key: int) -> int:
        f = -self._freq[key]
        i = bisect.bisect_left(self._neg_hot_freqs, f)
        while self._hot[i] != key:
            i += 1
        return i

    def compact(self) -> None:
        """Drop tombstones left by cold-node splices (housekeeping)."""
        self._cold = [k for k in self._cold if k is not None]
        self._cold_pos = {k: i for i, k in enumerate(self._cold)}
