"""Atomic checkpoints of trees of tensors (port of ``repro.checkpoint``).

Layout, the reference's: ``<dir>/step_<n>/arrays.npz`` + ``meta.json``,
written to a temp directory and renamed (atomic on POSIX) so a killed writer
can never leave a half checkpoint that ``latest_step`` would pick up. Each
array is named by its leaf's path string (``repro_torch.tree``, the same as
``jax.tree_util.keystr``), so a checkpoint written by the port restores into
the reference and the other way round.

Arrays are saved host-complete; ``restore`` puts each leaf on the device
and dtype of its ``like`` leaf. bf16 leaves are refused: ``.npz`` has no
bf16 type, and the reference's checkpoints cannot round-trip one either
(numpy stores it as raw void bytes that its restore cannot cast back), so
a bf16 checkpoint would be a format of the port's own with no reference to
restore into or from.

The ``.npz`` is written one array at a time (the format ``np.savez``
writes), so the host holds one leaf at a time, not the whole tree.

On a mesh (``repro_torch.distributed``) a rank holds only its block of each
leaf, where a JAX array is global. So ``save(..., shardings=...)`` gathers
the leaves from their blocks one at a time, rank 0 writes each at once and
every rank frees it before the next: a rank holds its blocks and one whole
leaf. ``restore(..., shardings=...)`` returns each leaf as this rank's
block of its ``NamedSharding``, reading only that block from the file where
the array is stored uncompressed: a checkpoint saved from one mesh restores
onto another, and across the two packages.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.distributed.shardings import block_index


def _check(leaf) -> None:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        raise TypeError("bf16 leaves cannot be checkpointed: .npz has no "
                        "bf16 type, and the reference's checkpoints cannot "
                        "round-trip one either (it stores raw bytes its "
                        "restore cannot cast back)")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, meta: dict | None = None,
         shardings=None) -> str:
    """Write ``tree`` as step ``step``. With ``shardings`` (a tree of
    ``NamedSharding``s, one per leaf) each leaf is this rank's block: every
    rank calls this, each leaf is gathered in turn, rank 0 writes it and
    all wait at the end until it has written them all."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = tree_lib.flatten_with_path(tree)
    for _, leaf in flat:          # on every rank, before any collective
        _check(leaf)
    shard_leaves = (tree_lib.leaves(shardings) if shardings is not None
                    else [None] * len(flat))
    if len(shard_leaves) != len(flat):
        raise ValueError(f"{len(shard_leaves)} shardings for {len(flat)} "
                         "leaves")
    if shardings is not None and dist.get_rank() != 0:
        for (_, leaf), sh in zip(flat, shard_leaves, strict=True):
            sh.gather(leaf)       # rank 0's turn to hold it
        dist.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                             zipfile.ZIP_STORED, allowZip64=True) as zf:
            for (path, leaf), sh in zip(flat, shard_leaves, strict=True):
                arr = _host(leaf if sh is None else sh.gather(leaf))
                with zf.open(path + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                del arr
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if shardings is not None:
        dist.barrier()
    return final


def _mapped(path: str, name: str) -> np.ndarray | None:
    """The array ``name`` of the ``.npz`` at ``path`` mapped from the file,
    so that slicing it reads only the slice; None where the member is
    compressed or holds no data to map."""
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(name + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        offset = f.tell()
    if dtype.hasobject or not shape or 0 in shape:
        return None
    return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape,
                     order="F" if fortran else "C")


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, shardings=None):
    """Load into the structure of ``like``: a tensor leaf comes back on the
    device and dtype of its ``like`` leaf, any other leaf as the saved
    array. With ``shardings`` (a tree of ``NamedSharding``s, one per leaf)
    every leaf comes back as this rank's block, on the mesh's device, in
    the dtype of its ``like`` leaf where that is a tensor (else the saved
    one), as ``jax.device_put(arr, sharding)`` does."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    flat = tree_lib.flatten_with_path(like)
    shard_leaves = (tree_lib.leaves(shardings) if shardings is not None
                    else [None] * len(flat))
    out = []
    with np.load(path) as data:
        for (p, leaf), sh in zip(flat, shard_leaves, strict=True):
            if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
                raise TypeError("bf16 leaves cannot be restored: .npz has "
                                "no bf16 type to read one back, and the "
                                "reference's checkpoints cannot round-trip "
                                "one either (its restore cannot cast the "
                                "raw bytes it stores)")
            if sh is not None:
                mapped = _mapped(path, p)
                arr = data[p] if mapped is None else mapped
                block = np.array(arr[block_index(
                    sh.mesh.shape, sh.spec, arr.shape, sh.mesh.coord)])
                del arr, mapped
                dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else None
                out.append(torch.from_numpy(block).to(device=sh.mesh.device,
                                                      dtype=dtype))
                continue
            arr = data[p]
            if isinstance(leaf, torch.Tensor):
                out.append(torch.from_numpy(arr).to(device=leaf.device,
                                                    dtype=leaf.dtype))
            else:
                out.append(arr)
    return tree_lib.unflatten(like, out)


def load_meta(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
