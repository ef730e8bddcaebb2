"""Atomic checkpoints of trees of tensors (port of ``repro.checkpoint``).

Layout, the reference's: ``<dir>/step_<n>/arrays.npz`` + ``meta.json``,
written to a temp directory and renamed (atomic on POSIX) so a killed writer
can never leave a half checkpoint that ``latest_step`` would pick up. Each
array is named by its leaf's path string (``repro_torch.tree``, the same as
``jax.tree_util.keystr``), so a checkpoint written by the port restores into
the reference and the other way round.

Arrays are saved host-complete; ``restore`` puts each leaf on the device
and dtype of its ``like`` leaf. Restoring onto new shardings waits for the
port's DeviceMesh (ROADMAP A11), and bf16 leaves for a bf16 training path
(A13): ``.npz`` has no bf16 type.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import tree as tree_lib


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bf16 leaves cannot be checkpointed yet: .npz "
                            "has no bf16 type (ROADMAP A13)")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree, meta: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {path: _host(leaf)
              for path, leaf in tree_lib.flatten_with_path(tree)}
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, shardings=None):
    """Load into the structure of ``like``: a tensor leaf comes back on the
    device and dtype of its ``like`` leaf, any other leaf as the saved
    array."""
    if shardings is not None:
        raise NotImplementedError("restoring onto shardings waits for the "
                                  "port's DeviceMesh (ROADMAP A11)")
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    out = []
    with np.load(path) as data:
        for p, leaf in tree_lib.flatten_with_path(like):
            arr = data[p]
            if isinstance(leaf, torch.Tensor):
                if leaf.dtype == torch.bfloat16:
                    raise TypeError("bf16 leaves cannot be restored yet "
                                    "(ROADMAP A13)")
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
