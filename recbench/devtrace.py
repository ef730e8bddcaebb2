"""A traced window's device activity, reduced from a ``torch.profiler``
trace to what the metric readers and the result's ``breakdown`` need.

The arithmetic of ``chip_smoke.py::phase_profile`` (device activity against
host wall time), with the busy time taken as the union of the device
operations' intervals, so that overlapping operations count once. No
chrome trace is written.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _events(prof):
    """(device, host) events of a stopped profiler as lists of (name,
    start_ns, end_ns)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            dev.append((e.name(), s, s + d))
        elif kind == DeviceType.CPU:
            host.append((e.name(), s, s + d))
    return dev, host


def union(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """The union of intervals [starts, ends) as sorted disjoint (k, 2)
    rows."""
    if starts.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:], s.size) - 1
    return np.stack([s[first], reach[last]], axis=1)


@dataclasses.dataclass
class DeviceTrace:
    """One traced window: ``window_s`` of host wall time in which ``steps``
    forward steps ran over pool entries ``pool_uses`` (counts per entry);
    ``names``, ``starts``, ``ends`` (ns) the device operations, ``host``
    the host's events in the same clock."""

    window_s: float
    steps: int
    pool_uses: np.ndarray
    names: list
    starts: np.ndarray
    ends: np.ndarray
    host: list

    @classmethod
    def from_profiler(cls, prof, window_s: float, steps: int,
                      pool_uses: np.ndarray) -> "DeviceTrace":
        dev, host = _events(prof)
        return cls(window_s, steps, pool_uses, [d[0] for d in dev],
                   np.array([d[1] for d in dev], dtype=np.int64),
                   np.array([d[2] for d in dev], dtype=np.int64),
                   sorted(host, key=lambda h: h[1]))

    @property
    def n_ops(self) -> int:
        return len(self.names)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        u = union(self.starts, self.ends)
        return float((u[:, 1] - u[:, 0]).sum()) * 1e-9

    def seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` takes."""
        return sum((e - s) for n, s, e in zip(self.names, self.starts,
                                              self.ends, strict=True)
                   if match(n)) * 1e-9

    def by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for n, s, e in zip(self.names, self.starts, self.ends, strict=True):
            out[n] = out.get(n, 0.0) + (e - s) * 1e-9
        return out

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations that took most time: [name, s]."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:k]
        return [[n, s] for n, s in ops]

    def idle_gaps(self, k: int = 10, scan: int = 64) -> list:
        """The device's idle time between its operations, summed by what
        the host was doing at each gap's middle (the innermost host event
        that spans it, or ``host python`` where none does): the ``k``
        largest as [name, s]."""
        u = union(self.starts, self.ends)
        if len(u) < 2:
            return []
        g0, g1 = u[:-1, 1], u[1:, 0]
        mids = (g0 + g1) // 2
        h_starts = np.array([h[1] for h in self.host], dtype=np.int64)
        last = np.searchsorted(h_starts, mids, side="right") - 1
        out: dict[str, float] = {}
        for m, j, gap in zip(mids.tolist(), last.tolist(),
                             ((g1 - g0) * 1e-9).tolist(), strict=True):
            name = "host python"
            for i in range(j, max(-1, j - scan), -1):
                if self.host[i][2] > m:
                    name = self.host[i][0]
                    break
            out[name] = out.get(name, 0.0) + float(gap)
        top = sorted(out.items(), key=lambda kv: -kv[1])[:k]
        return [[n, s] for n, s in top]
