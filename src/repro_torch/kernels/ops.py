"""Public kernel ops with the reference's signatures (``repro.kernels.ops``).

On a CUDA tensor each op launches its hand-written kernel; on a CPU tensor
it runs the kernel's plain version. There is no fallback between the two.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dot_interaction import dot_interaction as _dot_kernel
from repro_torch.kernels.recflash_sls import recflash_sls as _sls_kernel


def recflash_sls(hot, cold, indices, block_b: int = 8):
    """Two-tier SLS: hot (H,D) tier, cold (V-H,D) tier, indices (B,L) int32
    ranks into [hot; cold] -> (B,D) float32 bag sums."""
    return _sls_kernel(hot, cold, indices, block_b=block_b)


def dot_interaction(z, block_b: int = 64):
    """DLRM interaction: z (B,T,D) -> (B, T*(T-1)/2) upper-triangle dots."""
    return upper_triangle(_dot_kernel(z, block_b=block_b))


def upper_triangle(gram: torch.Tensor) -> torch.Tensor:
    """(B, T, T) -> (B, T*(T-1)/2): the strict upper triangle in row-major
    pair order (numpy's ``triu_indices(t, k=1)``)."""
    t = gram.shape[1]
    iu, ju = torch.triu_indices(t, t, 1, device=gram.device)
    return gram[:, iu, ju]


# plain versions re-exported for chip_smoke.py and tests
sls_ref = _ref.recflash_sls_ref
dot_ref = _ref.dot_interaction_ref
