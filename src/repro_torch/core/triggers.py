"""Online-training trigger policies (paper §III-C3/C4, Fig. 6-7).

Two policies:

* ``ThresholdTrigger`` (AdaEmbed-style): during inference, access counts of
  the online window are collected in a separate hash table (Fig. 6a). At the
  end of each period, training fires iff the number of window entries whose
  access frequency exceeds the inference table's top-x% threshold frequency
  (the hot-item region boundary, Fig. 6b) exceeds ``portion`` (default 0.1%)
  of the window-table entry count.
* ``PeriodTrigger`` (Modyn-style): train every ``period_days`` (daily = 1).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ThresholdTrigger:
    """Fire when enough *new* keys would enter the hot-item region.

    Fig. 7 caption: "new accessed vector IDs exceeding the top-x% access
    frequency threshold account for more than 0.1% of the total" — keys
    already inside the reference hot region don't count (a stable
    distribution must not re-trigger training every window).
    """

    top_frac: float = 0.05      # x% — hot-region share (Fig. 7a-c: 5/10/15%)
    portion: float = 0.001      # 0.1% of online-table entries

    def should_trigger(self, window_counts: dict[int, int],
                       threshold_freq: int,
                       hot_keys: frozenset = frozenset()) -> bool:
        if not window_counts:
            return False
        n_hot = sum(1 for k, f in window_counts.items()
                    if f > threshold_freq and k not in hot_keys)
        return n_hot > self.portion * len(window_counts)


@dataclasses.dataclass
class PeriodTrigger:
    """Fire every ``period_days`` regardless of access statistics."""

    period_days: int = 1

    def should_trigger(self, day: int) -> bool:
        return (day + 1) % self.period_days == 0
