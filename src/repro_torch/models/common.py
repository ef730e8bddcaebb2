"""Shared building blocks on torch tensors (params are nested dicts).

The reference's ``(d_in, d_out)`` weight layout is kept (``x @ w``), so that
JAX parameters transplant as plain copies. Random draws come from an
explicit ``torch.Generator`` on the target device.
"""

from __future__ import annotations

import math

import torch


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
