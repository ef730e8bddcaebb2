"""Two-tier SLS (kernel B1): the wrapper of ``csrc/recflash_sls.cu``.

Port of ``repro.kernels.recflash_sls.recflash_sls``, the Pallas TPU kernel
with a VMEM-resident hot prefix and row DMAs for cold hits. The source's
note says what bounds the CUDA kernel and how it serves the hot tier (from
L2, not shared memory, at the dlrm-rm2 prefix size).

On a CPU tensor the wrapper runs the plain version (``kernels.ref``). On a
CUDA tensor it launches the kernel on the current stream or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import recflash_sls_ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def threads_per_bag(dim: int, vec_elems: int) -> int:
    """Threads serving one bag: one per load unit of the row, rounded up to
    a power of two, at most a warp."""
    units = -(-dim // vec_elems)
    return min(32, 1 << (units - 1).bit_length())


def recflash_sls(hot: torch.Tensor, cold: torch.Tensor,
                 indices: torch.Tensor, block_b: int = 8) -> torch.Tensor:
    """Two-tier SLS. hot (H,D), cold (V-H,D), indices (B,L) -> (B,D) f32.

    ``indices`` are int32 ranks into [hot; cold]. ``block_b`` bags share one
    CUDA block (the batch tile of the TPU kernel's grid) and must divide B.
    """
    if hot.dim() != 2 or cold.dim() != 2 or hot.shape[1] != cold.shape[1]:
        raise ValueError(f"hot {tuple(hot.shape)} and cold "
                         f"{tuple(cold.shape)} must be (H, D) and (V-H, D)")
    if hot.dtype not in _build.DTYPE_CODES or cold.dtype != hot.dtype:
        raise TypeError(f"tables must both be float32 or bfloat16, got "
                        f"{hot.dtype} and {cold.dtype}")
    if indices.dim() != 2 or indices.dtype != torch.int32:
        raise TypeError(f"indices must be (B, L) int32, got "
                        f"{tuple(indices.shape)} {indices.dtype}")
    if hot.shape[0] < 1:
        raise ValueError("the hot tier needs at least one row")
    if not hot.device == cold.device == indices.device:
        raise ValueError("hot, cold and indices must be on one device")
    h, d = hot.shape
    b, n_lk = indices.shape
    if block_b < 1 or b % block_b:
        raise ValueError(f"batch {b} must divide by block_b {block_b}")
    if hot.device.type == "cpu":
        return recflash_sls_ref(hot, cold, indices)
    if hot.device.type != "cuda":
        raise ValueError(f"unsupported device {hot.device}")
    if not (hot.is_contiguous() and cold.is_contiguous()
            and indices.is_contiguous()):
        raise ValueError("hot, cold and indices must be contiguous")
    elems = 16 // hot.element_size()
    vec = (d % elems == 0 and hot.data_ptr() % 16 == 0
           and cold.data_ptr() % 16 == 0)
    group = threads_per_bag(d, elems if vec else 1)
    if block_b * group > 1024:
        raise ValueError(f"block_b {block_b} x {group} threads per bag "
                         "exceeds 1024 threads per block")
    out = torch.empty((b, d), dtype=torch.float32, device=hot.device)
    launch = _build.function("recflash_sls", "recflash_sls_launch", _ARGTYPES)
    with torch.cuda.device(hot.device):
        err = launch(hot.data_ptr(), cold.data_ptr(), indices.data_ptr(),
                     out.data_ptr(), h, h + cold.shape[0], d, b, n_lk,
                     block_b, _build.DTYPE_CODES[hot.dtype], int(vec), group,
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"recflash_sls kernel launch failed: CUDA error "
                           f"{err}")
    recflash_sls.launches += 1
    return out


recflash_sls.launches = 0   # kernel launches since the last reset
