"""DLRM pairwise-dot interaction (kernel B2): the wrappers of
``csrc/dot_interaction.cu``.

Port of ``repro.kernels.dot_interaction.dot_interaction``, the Pallas TPU
kernel computing batched Gram matrices on the MXU. One CUDA kernel serves
two entries:

- ``dot_interaction_fused``: the top-MLP input of ``dlrm.interact``
  (``bottom_out`` followed by the strict upper triangle of the Gram of
  ``[bottom_out; bags]``), written by the kernel in one launch;
- ``dot_interaction``: the full (B, T, T) Gram matrices, the TPU kernel's
  own contract.

The source's note says what bounds the kernel and how it is laid out. On a
CPU tensor a wrapper runs the plain version (``kernels.ref``), and on a
meta tensor its shapes only (the dry-run, ``launch.dryrun``). On a CUDA
tensor it launches the kernel on the current stream or raises.
Each entry's ``launches`` counts the launches it runs at once; one made
while the stream captures a CUDA graph is not counted, since its kernel
runs only when the graph replays (``models.dlrm``'s graph route), and no
wrapper sees a replay.

``DotInteractionFused`` gives the fused entry a gradient. The TPU kernel
has none (the reference differentiates its plain einsum), so the backward
is plain PyTorch on both devices: ``dot_interaction_fused_backward``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dot_interaction_fused_ref, dot_interaction_ref

# first, s0, rest, s1, out, batch, t, d, dtype, fused, aligned, stream
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _launch(first: torch.Tensor, s0: int, rest_ptr: int, s1: int,
            out: torch.Tensor, t: int, d: int, fused: bool) -> None:
    """Launch on the current stream: row 0 of sample b at ``first`` + b *
    s0, its rows 1..t-1 at ``rest_ptr`` + b * s1 (element strides). The
    launcher refuses a sample over 48 KB of shared memory (CUDA error 1)."""
    esize = first.element_size()
    aligned = (first.dtype == torch.float32 and first.data_ptr() % 16 == 0
               and rest_ptr % 16 == 0 and (s0 * esize) % 16 == 0
               and (s1 * esize) % 16 == 0)
    fn = _build.function("dot_interaction", "dot_interaction_launch",
                         _ARGTYPES)
    with torch.cuda.device(out.device):
        err = fn(first.data_ptr(), s0, rest_ptr, s1, out.data_ptr(),
                 out.shape[0], t, d, _build.DTYPE_CODES[first.dtype],
                 int(fused), int(aligned),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dot_interaction kernel launch failed: CUDA "
                           f"error {err}")


def dot_interaction(z: torch.Tensor, block_b: int = 64) -> torch.Tensor:
    """z (B, T, D) -> (B, T, T) float32 Gram matrices.

    ``block_b`` is the reference's batch tile: ``min(block_b, B)`` must
    divide B. The CUDA kernel itself runs one block per sample.
    """
    if z.dim() != 3:
        raise ValueError(f"z must be (B, T, D), got {tuple(z.shape)}")
    if z.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"z must be float32 or bfloat16, got {z.dtype}")
    b, t, d = z.shape
    block_b = min(block_b, b)
    if block_b < 1 or b % block_b:
        raise ValueError(f"batch {b} must divide by block_b {block_b}")
    if z.device.type in ("cpu", "meta"):
        return dot_interaction_ref(z)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")
    out = torch.empty((b, t, t), dtype=torch.float32, device=z.device)
    _launch(z, t * d, z.data_ptr() + d * z.element_size(), t * d, out, t, d,
            fused=False)
    if not torch.cuda.is_current_stream_capturing():
        dot_interaction.launches += 1
    return out


def dot_interaction_fused(bottom_out: torch.Tensor,
                          bags: torch.Tensor) -> torch.Tensor:
    """bottom_out (B, D), bags (B, T-1, D), both float32 or both bfloat16
    -> (B, D + T(T-1)/2) in their dtype: ``bottom_out``, then the strict
    upper triangle of the Gram of z = [bottom_out; bags] in
    ``numpy.triu_indices(T, k=1)`` order, which is what ``dlrm.interact``
    returns for the dot interaction. Each dot is accumulated in float32 and
    a bf16 one rounded once (the reference's bf16 einsum returns bf16)."""
    if bottom_out.dim() != 2 or bags.dim() != 3 or \
            bags.shape[0] != bottom_out.shape[0] or \
            bags.shape[2] != bottom_out.shape[1]:
        raise ValueError(f"bottom_out {tuple(bottom_out.shape)} and bags "
                         f"{tuple(bags.shape)} must be (B, D) and (B, T-1, D)")
    if bottom_out.dtype not in _build.DTYPE_CODES or \
            bags.dtype != bottom_out.dtype:
        raise TypeError(f"bottom_out and bags must both be float32 or "
                        f"bfloat16, got {bottom_out.dtype} and {bags.dtype}")
    if bags.device != bottom_out.device:
        raise ValueError("bottom_out and bags must be on one device")
    b, d = bottom_out.shape
    t = bags.shape[1] + 1
    if bottom_out.device.type in ("cpu", "meta"):
        return dot_interaction_fused_ref(bottom_out, bags)
    if bottom_out.device.type != "cuda":
        raise ValueError(f"unsupported device {bottom_out.device}")
    if bottom_out.stride(1) != 1 or bags.stride(2) != 1 or \
            (t > 2 and bags.stride(1) != d):
        raise ValueError("each sample's rows of bottom_out and bags must be "
                         "contiguous")
    out = torch.empty((b, d + t * (t - 1) // 2), dtype=bottom_out.dtype,
                      device=bottom_out.device)
    _launch(bottom_out, bottom_out.stride(0), bags.data_ptr(), bags.stride(0),
            out, t, d, fused=True)
    if not torch.cuda.is_current_stream_capturing():
        dot_interaction_fused.launches += 1
    return out


def dot_interaction_fused_backward(grad: torch.Tensor, bottom_out: torch.Tensor,
                                   bags: torch.Tensor
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient of ``dot_interaction_fused`` with respect to its inputs.

    ``grad`` (B, D + T(T-1)/2) is split into the gradient of ``bottom_out``
    (its first D columns) and of the upper-triangle dots, which go into a
    (B, T, T) matrix S; then dz = (S + S^T) z for z = [bottom_out; bags],
    ``d_bottom = grad[:, :D] + dz[:, 0]`` and ``d_bags = dz[:, 1:]``,
    computed in float32 (float64 for a float64 ``grad``) and returned in
    the dtypes of ``bottom_out`` and ``bags``.
    """
    b, d = bottom_out.shape
    t = bags.shape[1] + 1
    grad = grad.to(torch.promote_types(grad.dtype, torch.float32))
    z = torch.cat([bottom_out[:, None, :], bags], dim=1).to(grad.dtype)
    iu, ju = torch.triu_indices(t, t, 1, device=grad.device)
    s = grad.new_zeros((b, t, t))
    s[:, iu, ju] = grad[:, d:]
    dz = torch.bmm(s + s.transpose(1, 2), z)
    return ((grad[:, :d] + dz[:, 0]).to(bottom_out.dtype),
            dz[:, 1:].to(bags.dtype))


class DotInteractionFused(torch.autograd.Function):
    """``dot_interaction_fused`` with a gradient: ``apply(bottom_out,
    bags)``. The forward is the entry itself (the kernel on a CUDA tensor,
    the plain version on a CPU tensor); the backward is
    ``dot_interaction_fused_backward``, plain PyTorch on both devices."""

    @staticmethod
    def forward(ctx, bottom_out, bags):
        ctx.save_for_backward(bottom_out, bags)
        return dot_interaction_fused(bottom_out, bags)

    @staticmethod
    def backward(ctx, grad):
        return dot_interaction_fused_backward(grad, *ctx.saved_tensors)


dot_interaction.launches = 0         # launches run since the last reset
dot_interaction_fused.launches = 0   # launches run since the last reset
