"""DLRM pairwise-dot interaction (kernel B2): the wrapper of
``csrc/dot_interaction.cu``.

Port of ``repro.kernels.dot_interaction.dot_interaction``, the Pallas TPU
kernel computing batched Gram matrices on the MXU. The source's note says
what bounds the CUDA kernel and how it is laid out.

On a CPU tensor the wrapper runs the plain version (``kernels.ref``). On a
CUDA tensor it launches the kernel on the current stream or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dot_interaction_ref

SMEM_LIMIT = 48 * 1024      # static launch limit for dynamic shared memory
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


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
    if z.device.type == "cpu":
        return dot_interaction_ref(z)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")
    if t * (d + 1) * 4 > SMEM_LIMIT:
        raise ValueError(f"a ({t}, {d}) sample exceeds the kernel's "
                         f"{SMEM_LIMIT} B of shared memory")
    out = torch.empty((b, t, t), dtype=torch.float32, device=z.device)
    launch = _build.function("dot_interaction", "dot_interaction_launch",
                             _ARGTYPES)
    with torch.cuda.device(z.device):
        err = launch(z.data_ptr(), out.data_ptr(), b, t, d,
                     _build.DTYPE_CODES[z.dtype],
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dot_interaction kernel launch failed: CUDA "
                           f"error {err}")
    dot_interaction.launches += 1
    return out


dot_interaction.launches = 0   # kernel launches since the last reset
