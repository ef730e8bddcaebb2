"""Arithmetic of the yardstick: percentiles, the card's peaks, a kernel's
bound and the grouped SLS's bytes and adds. A model's FLOPs per sample are
its module's (``models/<module>.py``, ``Model.flops_per_sample``).

Frozen copies, so that the program cannot move its own yardstick:
``percentiles`` from ``repro_torch.serving.metrics``; ``bound_s`` and
``sls_bytes`` from ``chip_smoke.py`` (``bound_ms``, the grouped half of
``sls_bytes``).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

# one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12           # float32 on the CUDA cores, no tensor cores
BF16_FLOPS = 989e12


def percentiles(values: np.ndarray, qs: Sequence[float] = (50.0, 95.0, 99.0)
                ) -> tuple[float, ...]:
    """NaN-safe linear-interpolation percentiles (``np.percentile``): the
    non-finite entries dropped; all NaN where nothing is left."""
    v = np.asarray(values, dtype=np.float64)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return tuple(float("nan") for _ in qs)
    return tuple(float(np.percentile(v, q)) for q in qs)


def bound_s(n_bytes: float, n_flops: float,
            flops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak; and which of the two it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "ops")


def sls_bytes(tables: Sequence[torch.Tensor], dim: int, esize: int) -> float:
    """The bytes one grouped SLS launch over ``tables`` (each table's ids,
    (B, lookups) for one bag a sample) must move, each read once: the
    unique stored rows its ids touch and their unique ``rank_of`` entries
    (4 bytes each), the ids, and the bags it writes, in the tables' element
    size ``esize``. The remap is a bijection, so unique ids count unique
    stored rows."""
    total = 0
    for ids in tables:
        uniq = int(torch.unique(ids).numel())
        total += ids.numel() * 4 + ids.shape[0] * dim * esize \
            + uniq * (dim * esize + 4)
    return float(total)


def sls_adds(tables: Sequence[torch.Tensor], dim: int) -> float:
    """Additions of one grouped SLS launch: one per element of every row
    of every bag."""
    return float(sum(ids.numel() for ids in tables) * dim)
