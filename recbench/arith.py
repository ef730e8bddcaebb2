"""Arithmetic of the yardstick: percentiles, the card's peaks, a kernel's
bound, the grouped SLS's bytes and a DLRM's FLOPs per sample.

Frozen copies, so that the program cannot move its own yardstick:
``percentiles`` from ``repro_torch.serving.metrics``; ``bound_s`` and
``sls_bytes`` from ``chip_smoke.py`` (``bound_ms``, the grouped half of
``sls_bytes``); ``flops_per_sample`` from
``repro_torch.models.dlrm.DLRMConfig.flops_per_sample``, counting only the
work the model does (that one counts a bottom layer the model does not
have, all (n_tables + 1)^2 dots and 2 FLOPs an SLS add).
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


def sls_bytes(indices: torch.Tensor, dim: int, esize: int) -> float:
    """The bytes one grouped SLS launch over ``indices`` (B, n_tables, L)
    must move, each read once: the unique stored rows its ids touch and
    their unique ``rank_of`` entries (4 bytes each), the ids, and the bags
    it writes, in the tables' element size ``esize``. The remap is a
    bijection, so unique ids count unique stored rows."""
    b, n_t, _ = indices.shape
    total = indices.numel() * 4 + b * n_t * dim * esize
    for t in range(n_t):
        uniq = int(torch.unique(indices[:, t, :]).numel())
        total += uniq * (dim * esize + 4)
    return float(total)


def sls_adds(indices: torch.Tensor, dim: int) -> float:
    """Additions of one grouped SLS launch: one per element of every row
    of every bag."""
    return float(indices.numel() * dim)


def flops_per_sample(n_tables: int, n_dense: int, embed_dim: int,
                     lookups: int, bot_mlp: Sequence[int],
                     top_mlp: Sequence[int]) -> int:
    """A DLRM's forward FLOPs per sample: 2 x the MLPs' multiply-adds; 2 x
    ``embed_dim`` for each of the n(n-1)/2 distinct pairs of the n =
    n_tables + 1 vectors that the dot interaction multiplies; 1 for each
    element of each row that an SLS bag adds. ``bot_mlp`` and ``top_mlp``
    are the layer widths with the input and the output (256-128-64;
    128-64-1, its input width derived)."""
    n = n_tables + 1
    pairs = n * (n - 1) // 2
    f = sum(2 * a * b for a, b in zip(bot_mlp[:-1], bot_mlp[1:],
                                       strict=True))
    top = (embed_dim + pairs,) + tuple(top_mlp)
    f += sum(2 * a * b for a, b in zip(top[:-1], top[1:], strict=True))
    f += 2 * pairs * embed_dim
    f += n_tables * lookups * embed_dim
    return f
