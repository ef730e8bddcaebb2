"""Gradient compression for data-parallel all-reduce (port of
``repro.distributed.compression``).

``compressed_psum`` quantises a gradient block to ``bits``-bit integers
with a per-rank absmax scale, all-reduces the dequantised payload over the
data-parallel axis and divides by the axis size. ``CompressionState``
carries the error feedback (residual), so the quantisation noise is
unbiased over steps. The arithmetic is the reference's in its order:
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.mesh import Mesh, psum


@dataclasses.dataclass
class CompressionState:
    residual: torch.Tensor   # same shape as the gradient block, f32

    @classmethod
    def zeros_like(cls, g: torch.Tensor) -> "CompressionState":
        return cls(residual=torch.zeros_like(g, dtype=torch.float32))


def compressed_psum(g: torch.Tensor, axis_name, state: CompressionState
                    | None = None, bits: int = 8, *, mesh: Mesh):
    """Quantised all-reduce mean of this rank's ``g`` over ``axis_name``.

    Returns (mean gradient, new state). Compression error comes only from
    the local quantisation step, which error feedback absorbs.
    """
    n = mesh.axis_size(axis_name)
    g32 = g.to(torch.float32)
    if state is not None:
        g32 = g32 + state.residual
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp_min(g32.abs().max() / qmax, 1e-20)
    q = torch.clamp(torch.round(g32 / scale), -qmax, qmax).to(torch.int32)
    deq_local = q.to(torch.float32) * scale
    new_state = (CompressionState(residual=g32 - deq_local)
                 if state is not None else None)
    # scales differ per rank: sum the dequantised payloads, each scaled by
    # its rank's own scale
    total = psum(deq_local, mesh, axis_name)
    return total / n, new_state
