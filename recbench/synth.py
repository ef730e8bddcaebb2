"""Inputs made from the seed: embedding-table rows, MLP weights and biases,
and seeds for every random stream of a run.

Every table element is a counter-based function of (seed, table, row,
column), so that the plain reference regenerates only the rows a checked
batch touches, bit for bit, and never holds a second copy of a 48 GB set of
tables. The hash works on int64 tensors that hold 32-bit values, with every
product below 2**63, so it gives the same bits on the CPU and the card.
"""

from __future__ import annotations

import hashlib
import math

import torch

M32 = 0xFFFFFFFF
# elements a chunk of table rows is generated in (int64 temporaries of
# 256 MB each)
CHUNK_ELEMENTS = 1 << 25


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` of run ``seed``."""
    text = ":".join(str(x) for x in (seed, *tags)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser on int64 values in [0, 2**32); both
    multipliers are below 2**31, so no product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & M32
    return x ^ (x >> 16)


def table_rows(seed: int, table: int, rows: torch.Tensor, dim: int,
               scale: float, dtype: torch.dtype) -> torch.Tensor:
    """Rows ``rows`` (int64, any device) of logical table ``table``:
    (len(rows), dim), uniform in [-scale, scale) on a grid of 2**-24, in
    ``dtype`` (rounded to nearest from float32)."""
    key = derive(seed, "table", table)
    ka, kb = key & M32, (key >> 32) & M32
    rows = rows.to(torch.int64)
    row_h = _mix(_mix((rows + ka) & M32) ^ ((rows >> 32) & M32))
    col_h = _mix((torch.arange(dim, dtype=torch.int64, device=rows.device)
                  + kb) & M32)
    h = _mix(row_h[:, None] ^ col_h[None, :])
    u = (h >> 8).to(torch.float32) * (2.0 ** -24)
    return (u * (2.0 * scale) - scale).to(dtype)


def make_table(seed: int, table: int, n_rows: int, dim: int, scale: float,
               dtype: torch.dtype, device) -> torch.Tensor:
    """The whole logical table ``table`` on ``device``, in chunks of rows."""
    out = torch.empty((n_rows, dim), dtype=dtype, device=device)
    step = max(1, CHUNK_ELEMENTS // dim)
    for r0 in range(0, n_rows, step):
        r1 = min(n_rows, r0 + step)
        out[r0:r1] = table_rows(
            seed, table, torch.arange(r0, r1, device=device), dim, scale,
            dtype)
    return out


def mlp_weights(seed: int, name: str, sizes, dtype: torch.dtype,
                device) -> list[dict]:
    """An MLP's layers as the port holds them (``x @ w + b``, w of shape
    (d_in, d_out)), drawn on ``device`` from a generator seeded from
    ``seed``: w normal with standard deviation 1/sqrt(d_in); b normal with
    standard deviation 1/sqrt(d_out), as DLRM's reference code draws its
    biases (``create_mlp``), so that every bias add shows in the logits."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "mlp", name))
    layers = []
    for d_in, d_out in zip(sizes[:-1], sizes[1:], strict=True):
        w = torch.randn((d_in, d_out), generator=gen, device=device,
                        dtype=dtype).mul_(1.0 / math.sqrt(d_in))
        b = torch.randn((d_out,), generator=gen, device=device,
                        dtype=dtype).mul_(1.0 / math.sqrt(d_out))
        layers.append({"w": w, "b": b})
    return layers
