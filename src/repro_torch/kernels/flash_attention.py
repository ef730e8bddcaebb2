"""Flash attention, forward and FlashAttention-2 backward: the wrappers of
``csrc/flash_attention.cu``.

Port of ``repro.models.attention._flash_attention`` and its ``custom_vjp``.
The reference is plain jnp, not a Pallas kernel (XLA fuses its chunk loops
under ``jit`` on the TPU); on the card the port runs a hand-written kernel
instead of its eager chunk loop, on the route that ``route`` picks from the
dtype and the head-dim bucket alone:

- ``wgmma``: bf16; Hopper's warpgroup products fed by TMA;
- ``cuda_cores``: float32; register-blocked products on the CUDA cores in
  exact f32 (no TF32), eight warps a block, fed by ``cp.async``.

Both have instances at the buckets every LM config reaches (64/64,
128/128, 192/128; a smaller bucket runs zero-padded on 64/64), and both
make one forward and two backward launches a call (dq, which writes
delta, then dk/dv).

The source's note says what bounds each route and how it is laid out. A
CUDA tensor takes its route or raises: nothing runs another route when a
build or a launch fails.

- ``flash_attention_fwd``: (out, lse) from q (B, T, H, dqk), k (B, S, KV,
  dqk), v (B, S, KV, dv).
- ``flash_attention_bwd``: (dq, dk, dv) from the forward's inputs, its out
  and lse and the output's gradient.

Each counts its kernel launches (``launches``) and, per route, in
``routes``.

Both take the reference's ``q_start`` (global position of query row 0),
``causal``, ``q_chunk``, ``kv_chunk`` and ``scale``. The chunks only choose
the plain version's rounding points; the kernel tiles by its own sizes, but
the wrappers hold the chunking contract (``T % q_chunk == 0`` and ``S %
kv_chunk == 0``) on every device.

On a CPU tensor a wrapper runs the plain version (``kernels.ref``), and on a
meta tensor its shapes and operations only (the dry-run and ``op_stats``
count them). On a CUDA tensor it launches the kernel on the current stream
or raises: float32 or bfloat16, q, k and v alike; qk head dims up to 192 and
v head dims up to 128, each a multiple of 8 (the kernel's buckets, zero-
padded); the last dim contiguous, every other stride and each pointer
16-byte aligned. ``lse`` is (B, KV, T * n_rep) float32, row ``t * n_rep +
r`` the query head ``kv_head * n_rep + r``, on both devices.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_fwd_ref)

# ptrs (void* array), ints (long long array), scale, dtype, stream
_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
             ctypes.c_int, ctypes.c_void_p]
# the (qk, v) head-dim buckets the wrappers take, cheapest first; each runs
# on the cheapest of INSTANCES that holds it
BUCKETS = ((32, 32), (48, 32), (64, 64), (128, 128), (192, 128))
# the kernel instances each route builds, cheapest first (the source's
# FA_INSTANCES)
INSTANCES = ((64, 64), (128, 128), (192, 128))
# the launcher's route codes, and each route's launches a backward call
ROUTE_CODES = {"cuda_cores": 0, "wgmma": 1}
BWD_LAUNCHES = {"cuda_cores": 2, "wgmma": 2}


def bucket(dqk: int, dv: int) -> tuple[int, int]:
    """The kernel instance for qk head dim ``dqk`` and v head dim ``dv``:
    the cheapest bucket that holds both. Raises for a dim the kernel does
    not take."""
    if dqk % 8 or dv % 8 or dqk < 8 or dv < 8:
        raise ValueError(f"head dims must be positive multiples of 8 on a "
                         f"CUDA tensor, got qk {dqk} and v {dv}")
    for bq, bv in BUCKETS:
        if dqk <= bq and dv <= bv:
            return bq, bv
    raise ValueError(f"the flash attention kernel takes qk head dims up to "
                     f"{BUCKETS[-1][0]} and v head dims up to "
                     f"{BUCKETS[-1][1]}, got {dqk} and {dv}")


def route(dtype: torch.dtype, dims: tuple[int, int]
          ) -> tuple[str, tuple[int, int]]:
    """The kernel route for inputs of ``dtype`` at the bucket ``dims`` (a
    ``bucket`` result), ``wgmma`` (bf16) or ``cuda_cores`` (float32), and
    the instance that runs it: the cheapest of ``INSTANCES`` that holds
    the bucket (both routes build those). Raises for a dtype or a
    bucket no route takes."""
    dims = tuple(dims)
    if dims not in BUCKETS:
        raise ValueError(f"{dims} is not a head-dim bucket of the kernel "
                         f"({BUCKETS})")
    ways = {torch.float32: "cuda_cores", torch.bfloat16: "wgmma"}
    if dtype not in ways:
        raise TypeError(f"no flash attention route takes {dtype}")
    return ways[dtype], next(w for w in INSTANCES
                             if dims[0] <= w[0] and dims[1] <= w[1])


def _check(q, k, v, q_chunk: int, kv_chunk: int) -> None:
    """The contract on every device: shapes, dtypes and the chunking."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, T, H, d), (B, S, KV, d) and "
                         f"(B, S, KV, dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, dqk = q.shape
    if (k.shape[0] != b or k.shape[3] != dqk or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} "
                         f"kv heads")
    if q.dtype not in _build.DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must be on one device")
    if q_chunk < 1 or kv_chunk < 1 or t % q_chunk or k.shape[1] % kv_chunk:
        raise ValueError(f"T {t} and S {k.shape[1]} must divide by q_chunk "
                         f"{q_chunk} and kv_chunk {kv_chunk}")


def _strides(x: torch.Tensor, name: str) -> tuple[int, int, int]:
    """The (batch, seq, head) element strides of a (B, L, heads, d) tensor
    the kernel reads with 16-byte copies; raises where it cannot."""
    step = 16 // x.element_size()
    if x.stride(3) != 1 and x.shape[3] > 1:
        raise ValueError(f"{name}'s last dim must be contiguous, got strides "
                         f"{x.stride()}")
    if x.data_ptr() % 16 or any(x.stride(i) % step for i in range(3)
                                if x.shape[i] > 1):
        raise ValueError(f"{name} must be 16-byte aligned with strides that "
                         f"are multiples of {step} elements, got strides "
                         f"{x.stride()}")
    return x.stride(0), x.stride(1), x.stride(2)


def _launch(symbol: str, ptrs: list[int], ints: list[int], scale: float,
            dtype: torch.dtype, device: torch.device) -> None:
    """Launch on the current stream of ``device``."""
    fn = _build.function("flash_attention", symbol, _ARGTYPES)
    with torch.cuda.device(device):
        err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
                 (ctypes.c_longlong * len(ints))(*ints), scale,
                 _build.DTYPE_CODES[dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")


def _cuda_args(q, k, v, q_start: int, causal: bool, dout=None
               ) -> tuple[list[int], str]:
    """The launcher's integers (sizes, q_start, causal, the route's
    instance, the (batch, seq, head) strides of q, k, v and dout, then the
    route's code) and the route."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, t, h, dqk = q.shape
    s, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    if kv > 65535 or b > 65535:
        raise ValueError(f"batch {b} and kv heads {kv} must fit a grid "
                         f"dimension (65535)")
    strides = [*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"),
               *(_strides(dout, "dout") if dout is not None else (0, 0, 0))]
    way, dims = route(q.dtype, bucket(dqk, dv))
    return [b, t, s, h, kv, dqk, dv, int(q_start), int(causal), *dims,
            *strides, ROUTE_CODES[way]], way


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_start: int, causal: bool, q_chunk: int,
                        kv_chunk: int, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked online-softmax attention: (out (B, T, H, dv) in q's dtype,
    lse (B, KV, T * n_rep) float32). Query row ``i`` sits at ``q_start +
    i`` and, when ``causal``, sees keys ``0 .. q_start + i``."""
    _check(q, k, v, q_chunk, kv_chunk)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_fwd_ref(q, k, v, q_start, causal, q_chunk,
                                       kv_chunk, scale)
    ints, way = _cuda_args(q, k, v, q_start, causal)
    b, t, h, _ = q.shape
    kv, dv = k.shape[2], v.shape[3]
    out = torch.empty((b, t, h, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, kv, t * (h // kv)), dtype=torch.float32,
                      device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), 0, 0, lse.data_ptr(),
            0, out.data_ptr(), 0, 0, 0]
    _launch("flash_attention_fwd_launch", ptrs, ints, scale, q.dtype,
            q.device)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.routes[way] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, q_start: int, causal: bool,
                        q_chunk: int, kv_chunk: int, scale: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The FlashAttention-2 backward of ``flash_attention_fwd``: (dq, dk,
    dv) in q's, k's and v's dtypes, from the forward's ``out`` and ``lse``
    and the output's gradient ``dout`` (rounded to q's dtype first)."""
    _check(q, k, v, q_chunk, kv_chunk)
    if q.device.type in ("cpu", "meta"):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, q_start,
                                       causal, q_chunk, kv_chunk, scale)
    b, t, h, dqk = q.shape
    s, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (out.shape != (b, t, h, dv) or out.dtype != q.dtype
            or lse.shape != (b, kv, t * (h // kv))
            or lse.dtype != torch.float32 or dout.shape != out.shape
            or not out.device == lse.device == dout.device == q.device):
        raise ValueError("out, lse and dout must be the forward's: (B, T, H, "
                         "dv) in q's dtype, (B, KV, T * n_rep) float32 and "
                         "out's shape, on q's device")
    out, lse = out.contiguous(), lse.contiguous()
    dout = dout.to(q.dtype).contiguous()
    ints, way = _cuda_args(q, k, v, q_start, causal, dout)
    delta = torch.empty_like(lse)
    dq = torch.empty((b, t, h, dqk), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, kv, dqk), dtype=k.dtype, device=q.device)
    dvv = torch.empty((b, s, kv, dv), dtype=v.dtype, device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            out.data_ptr(), lse.data_ptr(), delta.data_ptr(), 0,
            dq.data_ptr(), dk.data_ptr(), dvv.data_ptr()]
    _launch("flash_attention_bwd_launch", ptrs, ints, scale, q.dtype,
            q.device)
    flash_attention_bwd.launches += BWD_LAUNCHES[way]
    flash_attention_bwd.routes[way] += BWD_LAUNCHES[way]
    return dq, dk, dvv


flash_attention_fwd.launches = 0    # kernel launches since the last reset
flash_attention_bwd.launches = 0    # kernel launches since the last reset
flash_attention_fwd.routes = dict.fromkeys(ROUTE_CODES, 0)    # by route
flash_attention_bwd.routes = dict.fromkeys(ROUTE_CODES, 0)    # by route
