"""Transplant reference (JAX) DLRM parameters into the port.

JAX's random draws cannot be reproduced in torch, so parity tests build the
reference's parameters, hand them across as numpy arrays
(``jax.tree.map(np.asarray, params)``) and copy them here. The layout is the
same on both sides: tables (V, D), and ``bot``/``top`` lists of
``{"w": (d_in, d_out), "b": (d_out,)}``. Remap state (``rank_of`` arrays and
``hot_sizes``) is carried over as well.
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
    out = {
        "tables": [_tensor(t, dev) for t in tree["tables"]],
        "bot": [{k: _tensor(v, dev) for k, v in layer.items()}
                for layer in tree["bot"]],
        "top": [{k: _tensor(v, dev) for k, v in layer.items()}
                for layer in tree["top"]],
    }
    if "rank_of" in tree:
        out = add_remap(out, [_tensor(r, dev) for r in tree["rank_of"]],
                        tree.get("hot_sizes"))
    return out
