"""Shared building blocks on torch tensors (params are nested dicts).

The reference's ``(d_in, d_out)`` weight layout is kept (``x @ w``), so that
JAX parameters transplant as plain copies. Random draws come from an
explicit ``torch.Generator`` on the target device.
"""

from __future__ import annotations

import math

import torch


class _MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the ``meta`` device, where they
    have shapes and no values (``torch.Generator`` takes no meta
    device)."""

    device = torch.device("meta")


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator seeded with ``seed`` that the init helpers draw from on
    ``device`` (``meta`` too: shapes only, nothing allocated)."""
    gen = (_MetaGenerator() if device.type == "meta"
           else torch.Generator(device=device))
    gen.manual_seed(seed)
    return gen


def uniform_init(gen: torch.Generator, shape, scale,
                 dtype=torch.float32) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
    return u.mul_(2 * scale).sub_(scale)


def normal_init(gen: torch.Generator, shape, stddev,
                dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype).mul_(stddev)


def dense_init(gen: torch.Generator, d_in, d_out, dtype=torch.float32,
               bias=False) -> dict:
    """He/LeCun-style fan-in init for a linear layer."""
    w = normal_init(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` in the dtype JAX promotes the two to: float32 input
    on bf16 weights gives float32, as in the reference (torch's matmul
    wants one dtype)."""
    w = params["w"]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt)
    if "b" in params:
        y = y + params["b"]
    return y


def bce_with_logits(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample binary cross-entropy of ``logits`` against labels ``y``,
    written as the reference writes it (``max(l, 0) - l*y +
    log1p(exp(-|l|))``), not as ``F.binary_cross_entropy_with_logits``,
    whose rounding differs. ``|l|`` takes JAX's slope at 0 (1, where
    ``torch.abs`` takes 0), so that a logit of exactly 0 (a sample whose
    last hidden layer is all dead, under zero-initialised biases) gets the
    reference's gradient too: ``-y`` there, not ``0.5 - y``."""
    abs_l = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, logits.new_zeros(())) - logits * y
            + torch.log1p(torch.exp(-abs_l)))


def mlp_init(gen: torch.Generator, sizes, dtype=torch.float32,
             bias=True) -> list:
    return [dense_init(gen, a, b, dtype, bias)
            for a, b in zip(sizes[:-1], sizes[1:], strict=True)]


def mlp(params, x: torch.Tensor, act=torch.relu, final_act=None):
    for i, layer in enumerate(params):
        x = dense(layer, x)
        if i < len(params) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis with the population variance, written
    as the reference writes it (not ``F.layer_norm``, whose rounding
    differs)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


def ln_init(d: int, dtype=torch.float32,
            device: str | torch.device = "cpu") -> dict:
    return {"gamma": torch.ones((d,), dtype=dtype, device=device),
            "beta": torch.zeros((d,), dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis: the mean square in float32, its
    ``rsqrt`` cast back to ``x``'s dtype before the multiply (the
    reference's rounding, not ``F.rms_norm``'s)."""
    var = (x.float() ** 2).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


def rms_init(d: int, dtype=torch.float32,
             device: str | torch.device = "cpu") -> dict:
    return {"gamma": torch.ones((d,), dtype=dtype, device=device)}


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """Primer's squared ReLU (Nemotron-4 FFN activation)."""
    r = torch.relu(x)
    return r * r


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0, dtype=torch.float32):
    """(..., T) int positions -> cos/sin of shape (..., T, head_dim/2): the
    angles in float32, cast to ``dtype``."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device)
                           / head_dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, D) with cos/sin (..., T, 1 or H, D/2). Rotates the two
    halves of the head dim against each other (not interleaved pairs)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
