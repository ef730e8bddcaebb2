"""Transplant reference (JAX) parameters into the port.

JAX's random draws cannot be reproduced in torch, so parity tests build the
reference's parameters, hand them across as numpy arrays
(``jax.tree.map(np.asarray, params)``) and copy them here. The layout is the
same on both sides. ``from_jax_params`` takes a DLRM's (tables (V, D), and
``bot``/``top`` lists of ``{"w": (d_in, d_out), "b": (d_out,)}``) and
carries its remap state over (``rank_of`` arrays and ``hot_sizes``, whose
kernel descriptors it builds); ``from_jax_tree`` copies any other model's
tree (DIN, BERT4Rec, GraphSAGE, the LMs) as it is. An LM tree keeps the
reference's layout: ``dense_layers``/``moe_layers`` stacked on a leading
``L`` dim, bf16 weights beside float32 MoE routers (each leaf in its own
dtype), and the MTP block's unstacked layer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.dlrm import add_remap


def _tensor(x, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(x)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16 from JAX
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def from_jax_params(tree: dict, device: str | torch.device = "cuda") -> dict:
    """Reference DLRM params as numpy arrays -> port params on ``device``."""
    dev = resolve_device(device)
    out = from_jax_tree({k: tree[k] for k in ("tables", "bot", "top")}, dev)
    if "rank_of" in tree:
        out = add_remap(out, [_tensor(r, dev) for r in tree["rank_of"]],
                        tree.get("hot_sizes"))
    return out


def from_jax_tree(tree, device: str | torch.device = "cuda"):
    """A reference param tree (nested dicts, lists and tuples of numpy
    arrays) -> the same tree of tensors on ``device``, each array copied
    in its dtype (bf16 included)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_tree(v, dev) for v in tree)
    return _tensor(tree, dev)
