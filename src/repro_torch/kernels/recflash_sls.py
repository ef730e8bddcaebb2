"""Two-tier SLS (kernel B1): the wrappers of ``csrc/recflash_sls.cu``.

Port of ``repro.kernels.recflash_sls.recflash_sls``, the Pallas TPU kernel
with a VMEM-resident hot prefix and row DMAs for cold hits. One CUDA kernel
serves two entries:

- ``recflash_sls_grouped``: every table of a batch in one launch, logical
  ids translated through each table's ``rank_of`` inside the kernel. The
  tables are named by a small device array of descriptors (``describe``),
  built once (``dlrm.add_remap``). ``TableDescs.check`` is the one rule
  for whether they still name the tables: the wrapper runs it on every
  call, and ``models.dlrm``'s graph route on every replay.
- ``recflash_sls``: one table given as its two tiers and ranks, the TPU
  kernel's own contract.

The source's note says what bounds the kernel and how it serves the hot
tier (blocks of one table each, hot row loads cached in each SM's L1,
the rest of the prefix in L2; rows loaded straight into registers, not
staged in shared memory). On a CPU
tensor a wrapper runs the plain version (``kernels.ref``), and on a meta
tensor its shapes only (the dry-run, ``launch.dryrun``). On a CUDA tensor
it launches the kernel on the current stream or raises.
Each entry's ``launches`` counts the launches it runs at once; one made
while the stream captures a CUDA graph is not counted, since its kernel
runs only when the graph replays (``models.dlrm``'s graph route), and no
wrapper sees a replay.

Both entries add each bag in float32 in lookup order and return it in the
tables' dtype (float32 or bfloat16). An id out of range is clamped into
range on both devices (see ``recflash_sls_grouped``).

The grouped entry takes every table's bags at one length, indices (B,
n_tables, L), or with ``lookups`` one length a table (ragged bags, as
DLRM-DCNv2's): indices (B, sum(lookups)), table t's ids in its own columns
``[off_t, off_t + lookups[t])``, ``off_t`` the sum of the lengths before it.
The lengths and offsets go to the kernel in its launch's arguments (a
CUDA graph captures them), so a ragged call copies nothing to the card and
builds no descriptor.

``RecFlashSLSGrouped`` gives the grouped entry, over either layout, a
gradient for each stored table. The TPU kernel has none (the reference
differentiates its plain ``jnp.take`` bags), so the backward is plain
PyTorch on both devices: ``recflash_sls_grouped_backward``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools

import torch

from repro_torch.embedding.layout import lookup
from repro_torch.kernels import _build
from repro_torch.kernels.ref import recflash_sls_grouped_ref, recflash_sls_ref

# descs, hot, cold, hot_rows, rows, indices, s_b, s_t, s_l, out, batch,
# n_tables, lookups, dim, dtype, vec, ragged, stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] + [ctypes.c_longlong] * 3
             + [ctypes.c_void_p] + [ctypes.c_int] * 6
             + [ctypes.c_void_p] * 2)
# the most tables a ragged launch takes (the kernel's kMaxRagged)
MAX_RAGGED_TABLES = 128
# the row loads a thread keeps in flight on the 16-byte path (kDepthShort,
# kDepthLong): the longer where a launch's bags average at least twice it
PIPELINE_DEPTHS = (8, 12)


_STALE = ("the descriptors no longer match the tables they name (a table, "
          "hot size or rank_of was replaced); describe the tables again "
          "(dlrm.add_remap)")


@dataclasses.dataclass(frozen=True)
class TableDescs:
    """The grouped kernel's view of a group of stored tables.

    ``tensor`` holds, per table, ``(hot ptr, cold ptr, rank_of ptr or 0,
    hot rows, rows, rank_of entries)``: an (n_tables, 6) int64 tensor on
    the tables' device, the kernel's ``TableDesc`` array. ``key`` names the
    tensors it was built from (``_key``); ``vec`` says whether every tier
    allows 16-byte copies.
    """

    tensor: torch.Tensor
    key: tuple
    vec: bool

    def check(self, tables, hot_sizes, rank_of) -> None:
        """Raise ValueError unless these descriptors still name ``tables``
        split at ``hot_sizes`` with ``rank_of``: every pointer and shape and
        every hot size as when they were built."""
        if _key(tables, hot_sizes, rank_of) != self.key:
            raise ValueError(_STALE)


def _key(tables, hot_sizes, rank_of) -> tuple:
    """What a set of descriptors names: the tables' and rank_of tensors'
    pointers and shapes, and the hot sizes. (``map`` over the unbound
    methods: the graph route runs this on every replay.)"""
    named = [*tables, *(rank_of or ())]
    return (tuple(map(torch.Tensor.data_ptr, named)),
            tuple(map(torch.Tensor.size, named)), tuple(hot_sizes))


def describe(tables, hot_sizes, rank_of=None) -> TableDescs:
    """Descriptors of stored ``tables`` split at ``hot_sizes``, with their
    ``rank_of`` hash tables (or None: the indices are ranks)."""
    n = len(tables)
    if n < 1 or len(hot_sizes) != n or (rank_of is not None
                                        and len(rank_of) != n):
        raise ValueError(f"need one hot size and one rank_of (or none) per "
                         f"table: {n} tables, {len(hot_sizes)} hot sizes")
    first = tables[0]
    if first.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"tables must be float32 or bfloat16, got "
                        f"{first.dtype}")
    rows = []
    for t, (table, h) in enumerate(zip(tables, hot_sizes, strict=True)):
        if (table.dim() != 2 or table.shape[1] != first.shape[1]
                or table.dtype != first.dtype
                or table.device != first.device):
            raise ValueError(f"table {t} {tuple(table.shape)} {table.dtype} "
                             f"on {table.device} differs from table 0 "
                             f"{tuple(first.shape)} {first.dtype} on "
                             f"{first.device}")
        if not table.is_contiguous():
            raise ValueError(f"table {t} must be contiguous")
        v, h = table.shape[0], int(h)
        if not 1 <= h <= v:
            raise ValueError(f"table {t}: hot size {h} outside [1, {v}]")
        ro_ptr, n_ids = 0, v
        if rank_of is not None:
            ro = rank_of[t]
            if (ro.dim() != 1 or ro.dtype != torch.int32
                    or ro.device != first.device or not ro.is_contiguous()):
                raise TypeError(f"rank_of[{t}] must be a contiguous (V,) "
                                f"int32 tensor on {first.device}")
            ro_ptr, n_ids = ro.data_ptr(), ro.shape[0]
        base = table.data_ptr()
        rows.append((base, base + h * table.stride(0) * table.element_size(),
                     ro_ptr, h, v, n_ids))
    return TableDescs(torch.tensor(rows, dtype=torch.int64,
                                   device=first.device),
                      _key(tables, hot_sizes, rank_of),
                      _vec_ok(first.shape[1], first.dtype,
                              [p for r in rows for p in r[:2]]))


@functools.lru_cache(maxsize=64)
def _ragged_arg(lookups: tuple) -> ctypes.Array:
    """The launcher's ``ragged`` argument: the lengths, then each table's
    first column (kept alive by the cache)."""
    vals = list(lookups) + [0, *itertools.accumulate(lookups)][:-1]
    return (ctypes.c_int * len(vals))(*vals)


def _launch(descs: int, one: tuple[int, int, int, int],
            indices: torch.Tensor, out: torch.Tensor, dim: int,
            dtype: torch.dtype, vec: bool, lookups: tuple | None = None
            ) -> None:
    """Launch on the current stream; ``indices`` is (B, n_tables, L), or
    (B, sum(lookups)) for ragged ``lookups``."""
    if lookups is None:
        b, n_t, n_lk = indices.shape
        strides, ragged = indices.stride(), None
    else:
        b, n_t, n_lk = indices.shape[0], len(lookups), max(lookups)
        strides = (indices.stride(0), 0, indices.stride(1))
        ragged = ctypes.addressof(_ragged_arg(lookups))
    fn = _build.function("recflash_sls", "recflash_sls_launch", _ARGTYPES)
    with torch.cuda.device(out.device):
        err = fn(descs, *one, indices.data_ptr(), *strides,
                 out.data_ptr(), b, n_t, n_lk, dim, _build.DTYPE_CODES[dtype],
                 int(vec), ragged, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"recflash_sls kernel launch failed: CUDA error "
                           f"{err}")


def _vec_ok(dim: int, dtype: torch.dtype, ptrs) -> bool:
    """16-byte copies: D fills whole vectors and every tier is aligned."""
    return dim % (16 // dtype.itemsize) == 0 and all(p % 16 == 0
                                                     for p in ptrs)


def recflash_sls(hot: torch.Tensor, cold: torch.Tensor,
                 indices: torch.Tensor, block_b: int = 8) -> torch.Tensor:
    """Two-tier SLS of one table. hot (H,D), cold (V-H,D), indices (B,L)
    int32 ranks into [hot; cold] -> (B,D) in the tables' dtype, added in
    float32. A rank outside [0, V) is clamped into it: -1 reads row 0, V
    and above row V-1. (The TPU kernel reads ``hot[H-1]`` for -1, and the
    reference's ``jnp.take`` fills: NaN at V and above.)

    ``block_b`` is the TPU kernel's batch tile and must divide B; the CUDA
    kernel serves 128 / (threads per bag) bags per block whatever it is.
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
    b = indices.shape[0]
    if block_b < 1 or b % block_b:
        raise ValueError(f"batch {b} must divide by block_b {block_b}")
    if hot.device.type in ("cpu", "meta"):
        return recflash_sls_ref(hot, cold, indices)
    if hot.device.type != "cuda":
        raise ValueError(f"unsupported device {hot.device}")
    if not (hot.is_contiguous() and cold.is_contiguous()
            and indices.is_contiguous()):
        raise ValueError("hot, cold and indices must be contiguous")
    out = torch.empty((b, d), dtype=hot.dtype, device=hot.device)
    _launch(0, (hot.data_ptr(), cold.data_ptr(), h, h + cold.shape[0]),
            indices[:, None, :], out, d, hot.dtype,
            _vec_ok(d, hot.dtype, (hot.data_ptr(), cold.data_ptr())))
    if not torch.cuda.is_current_stream_capturing():
        recflash_sls.launches += 1
    return out


def _check_ragged(lookups, n_tables: int, indices: torch.Tensor) -> tuple:
    """``lookups`` as a tuple of ints, checked against the tables and the
    (B, sum(lookups)) int32 ``indices``."""
    lookups = tuple(int(n) for n in lookups)
    if len(lookups) != n_tables or min(lookups) < 1:
        raise ValueError(f"need a bag length of at least 1 for each of the "
                         f"{n_tables} tables, got {lookups}")
    if n_tables > MAX_RAGGED_TABLES:
        raise ValueError(f"a ragged launch takes at most "
                         f"{MAX_RAGGED_TABLES} tables, got {n_tables}")
    if (indices.dim() != 2 or indices.dtype != torch.int32
            or indices.shape[1] != sum(lookups)):
        raise TypeError(f"ragged indices must be (B, {sum(lookups)}) int32, "
                        f"got {tuple(indices.shape)} {indices.dtype}")
    return lookups


def recflash_sls_grouped(tables, hot_sizes, indices: torch.Tensor,
                         rank_of=None, desc: TableDescs | None = None,
                         lookups=None) -> torch.Tensor:
    """Two-tier SLS of every table of a batch in one launch.

    ``tables`` are the stored (rank-ordered) (V_t, D) tables, each split at
    its ``hot_sizes`` entry into the hot and cold tiers; ``indices`` (B,
    n_tables, L) int32 logical ids, read with their strides, translated
    through ``rank_of[t]`` inside the kernel (ranks when ``rank_of`` is
    None). With ``lookups``, one bag length (at least 1) a table, the
    indices are ragged instead: (B, sum(lookups)), table t's ids in its own
    columns (module docstring). ``desc`` are the tables' descriptors from
    ``describe``, checked against the arguments (``TableDescs.check``), or
    None to build them for this call.
    Returns (B, n_tables, D) in the tables' dtype, each bag added in
    float32 in lookup order and rounded once.

    Ids out of range are clamped, on both devices: an id into
    [0, len(rank_of[t])) before the translation, a rank into [0, V_t). So
    -1 reads the row of id 0 and an id at or past the end that of the last
    id. The reference forward's ``jnp.take`` fills instead: -1 reads the
    row of id V-1 there, and an id at or past V gives a NaN bag.
    """
    if desc is None:
        desc = describe(tables, hot_sizes, rank_of)
    else:
        desc.check(tables, hot_sizes, rank_of)
    dev = tables[0].device
    if lookups is not None:
        lookups = _check_ragged(lookups, len(tables), indices)
    elif (indices.dim() != 3 or indices.dtype != torch.int32
            or indices.shape[1] != len(tables)):
        raise TypeError(f"indices must be (B, {len(tables)}, L) int32, got "
                        f"{tuple(indices.shape)} {indices.dtype}")
    if indices.device != dev:
        raise ValueError("tables and indices must be on one device")
    if dev.type in ("cpu", "meta"):
        return recflash_sls_grouped_ref(tables, hot_sizes, indices, rank_of,
                                        lookups)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b, n_t = indices.shape[0], len(tables)
    d, dtype = tables[0].shape[1], tables[0].dtype
    out = torch.empty((b, n_t, d), dtype=dtype, device=dev)
    _launch(desc.tensor.data_ptr(), (0, 0, 0, 0), indices, out, d, dtype,
            desc.vec, lookups)
    if not torch.cuda.is_current_stream_capturing():
        recflash_sls_grouped.launches += 1
    return out


def recflash_sls_grouped_backward(grad: torch.Tensor, n_rows, indices,
                                  rank_of=None, needs=None,
                                  lookups=None) -> list:
    """Gradient of the grouped SLS with respect to each stored table.

    ``grad`` (B, n_tables, D) is the gradient of the bags; ``n_rows`` the
    stored tables' row counts; ``indices``, ``rank_of`` and ``lookups`` the
    forward's (a ragged layout where ``lookups`` is given), clamped as the
    forward clamps them. Returns per table a dense (V_t, D) tensor,
    accumulated in float32 (float64 for a float64 ``grad``): zeros, then
    each bag's gradient added at the rank of each of its lookups
    (``index_add_``), which is the dense gradient ``jax.grad`` gives through
    ``jnp.take``. A table whose ``needs`` entry is False gets None.
    """
    b, d = indices.shape[0], grad.shape[2]
    cols = (indices.unbind(1) if lookups is None
            else indices.split(tuple(lookups), dim=1))
    grad = grad.to(torch.promote_types(grad.dtype, torch.float32))
    out = []
    for t, (v, idx) in enumerate(zip(n_rows, cols, strict=True)):
        if needs is not None and not needs[t]:
            out.append(None)
            continue
        n_lk = idx.shape[1]
        if rank_of is not None:
            idx = lookup(rank_of[t], idx)
        g = torch.zeros((v, d), dtype=grad.dtype, device=grad.device)
        g.index_add_(0, idx.reshape(-1).clamp(0, v - 1),
                     grad[:, t, None, :].expand(b, n_lk, d).reshape(-1, d))
        out.append(g)
    return out


class RecFlashSLSGrouped(torch.autograd.Function):
    """``recflash_sls_grouped`` with a gradient for each stored table:
    ``apply(hot_sizes, indices, rank_of, desc, lookups, *tables)``, with
    ``lookups`` None for uniform bags and the bag lengths for ragged ones.

    The forward is the entry itself (the kernel on a CUDA tensor, the plain
    version on a CPU tensor); the backward is
    ``recflash_sls_grouped_backward``, plain PyTorch on both devices, each
    table's gradient returned in the table's dtype.
    """

    @staticmethod
    def forward(ctx, hot_sizes, indices, rank_of, desc, lookups, *tables):
        ctx.save_for_backward(indices)
        ctx.rank_of, ctx.lookups = rank_of, lookups
        ctx.meta = [(t.shape[0], t.dtype) for t in tables]
        return recflash_sls_grouped(list(tables), hot_sizes, indices, rank_of,
                                    desc, lookups)

    @staticmethod
    def backward(ctx, grad):
        (indices,) = ctx.saved_tensors
        grads = recflash_sls_grouped_backward(
            grad, [v for v, _ in ctx.meta], indices, ctx.rank_of,
            ctx.needs_input_grad[5:], ctx.lookups)
        return (None,) * 5 + tuple(
            g if g is None else g.to(dt)
            for g, (_, dt) in zip(grads, ctx.meta, strict=True))


recflash_sls.launches = 0           # launches run since the last reset
recflash_sls_grouped.launches = 0   # launches run since the last reset
