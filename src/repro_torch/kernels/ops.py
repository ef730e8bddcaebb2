"""Public kernel ops with the reference's signatures (``repro.kernels.ops``),
the grouped and fused entries the port's forward takes, and flash
attention's forward and backward (``models.attention`` differentiates
through them).

On a CUDA tensor each op launches its hand-written kernel; on a CPU tensor
it runs the kernel's plain version. There is no fallback between the two.
The grouped and fused entries take their ``autograd.Function`` when a
gradient is wanted (grad mode on and an input that requires one), so that
a training step differentiates through the kernels; otherwise, as under
``torch.no_grad`` or ``torch.inference_mode``, they call the kernel's
wrapper directly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dot_interaction import DotInteractionFused
from repro_torch.kernels.dot_interaction import dot_interaction as _dot_kernel
from repro_torch.kernels.dot_interaction import (
    dot_interaction_fused as _fused_kernel)
from repro_torch.kernels import flash_attention as _attn
from repro_torch.kernels.recflash_sls import RecFlashSLSGrouped
from repro_torch.kernels.recflash_sls import recflash_sls as _sls_kernel
from repro_torch.kernels.recflash_sls import (
    recflash_sls_grouped as _grouped_kernel)


def recflash_sls(hot, cold, indices, block_b: int = 8):
    """Two-tier SLS: hot (H,D) tier, cold (V-H,D) tier, indices (B,L) int32
    ranks into [hot; cold] -> (B,D) bag sums in the tables' dtype, added in
    float32.

    A rank out of range is clamped into [0, V) on both devices: -1 reads
    row 0. The reference (``repro.kernels.ops.recflash_sls``, whose oracle
    is ``jnp.take``) differs there: its oracle reads row V-1 for -1 and
    gives NaN for V and above.
    """
    return _sls_kernel(hot, cold, indices, block_b=block_b)


def recflash_sls_grouped(tables, hot_sizes, indices, rank_of=None,
                         desc=None, lookups=None):
    """Two-tier SLS of all tables in one launch: stored tables split at
    ``hot_sizes``, indices (B, n_tables, L) int32 logical ids translated by
    ``rank_of`` (or ranks) -> (B, n_tables, D) bag sums in the tables'
    dtype, added in float32. With ``lookups``, one bag length a table, the
    indices are ragged: (B, sum(lookups)), table t's ids in its own columns
    (``kernels.recflash_sls``).

    An id is clamped into [0, len(rank_of[t])) and a rank into [0, V_t), on
    both devices. The reference forward's ``jnp.take`` fills instead: -1
    reads the row of id V-1, and an id at or past V gives NaN.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return RecFlashSLSGrouped.apply(hot_sizes, indices, rank_of, desc,
                                        lookups, *tables)
    return _grouped_kernel(tables, hot_sizes, indices, rank_of, desc, lookups)


def dot_interaction(z, block_b: int = 64):
    """DLRM interaction: z (B,T,D) -> (B, T*(T-1)/2) upper-triangle dots."""
    return upper_triangle(_dot_kernel(z, block_b=block_b))


def dot_interaction_fused(bottom_out, bags):
    """DLRM top-MLP input: bottom_out (B,D), bags (B,T-1,D) ->
    (B, D + T*(T-1)/2) in their dtype, ``bottom_out`` then the
    upper-triangle dots (accumulated in float32)."""
    if torch.is_grad_enabled() and (bottom_out.requires_grad
                                    or bags.requires_grad):
        return DotInteractionFused.apply(bottom_out, bags)
    return _fused_kernel(bottom_out, bags)


# flash attention's forward, (out, lse), and its FlashAttention-2 backward,
# (dq, dk, dv): ``models.attention.FlashAttention`` differentiates through
# them
flash_attention_fwd = _attn.flash_attention_fwd
flash_attention_bwd = _attn.flash_attention_bwd

upper_triangle = _ref.upper_triangle

# plain versions re-exported for chip_smoke.py and tests
sls_ref = _ref.recflash_sls_ref
sls_grouped_ref = _ref.recflash_sls_grouped_ref
dot_ref = _ref.dot_interaction_ref
fused_ref = _ref.dot_interaction_fused_ref
attn_fwd_ref = _ref.flash_attention_fwd_ref
attn_bwd_ref = _ref.flash_attention_bwd_ref
