"""What every model's plain reference shares: float32 matrix products with
TF32 off, MLP layers as the harness draws them, the control's TF32
rounding and the block of samples a reference works in. A model's own
reference (its bags, its interaction) is its module's
``Model.reference_logits`` (``models/<module>.py``). Nothing here imports
the program.

``precision="tf32"`` is the control: every matrix product's operands
rounded to TF32 (10 mantissa bits, to nearest even) first, as the tensor
cores' TF32 mode does, on the CPU as on the card. ``"tf32-card"`` lets the
card's own TF32 mode compute the matrix products instead (a witness that
the rounding stands for it).
"""

from __future__ import annotations

import contextlib

import torch

BLOCK = 8192        # samples a block, so that a check fits beside nothing


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def products(precision: str):
    """The card's matrix products in float32 with TF32 off, or with it on
    for ``"tf32-card"``, for the body; the setting restored after."""
    if precision not in ("float32", "tf32", "tf32-card"):
        raise ValueError(f"unknown precision {precision!r}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32-card"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def mlp(layers, x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w + b`` a layer, ReLU between layers, weights of a lower dtype
    widened to float32 first."""
    for i, layer in enumerate(layers):
        x = _mm(x, layer["w"].float(), precision) + layer["b"].float()
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x
