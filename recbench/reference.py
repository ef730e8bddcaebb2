"""The plain reference of a DLRM (Naumov et al., arXiv:1906.00091) in
float32, with TF32 off: no remap, no ``rank_of``, no kernel, nothing of the
program.

It reads the logical tables, regenerating only the rows a block of samples
touches (``synth.table_rows``), adds each bag in float32 and rounds it to
the tables' dtype, runs the bottom MLP, the dot interaction (the bottom
output, then the strict upper triangle of the Gram of [bottom; bags] in
row-major pair order) and the top MLP. Weights of a lower dtype are
widened to float32 first. It works in blocks of samples, so that a check of
dlrm-mlperf fits beside nothing else on the card.

``precision="tf32"`` is the control: every matrix product's operands
rounded to TF32 (10 mantissa bits, to nearest even) first, as the tensor
cores' TF32 mode does, on the CPU as on the card. ``"tf32-card"`` lets the
card's own TF32 mode compute the matrix products instead (a witness that
the rounding stands for it).
"""

from __future__ import annotations

import torch

from recbench.synth import table_rows

BLOCK = 8192        # samples a block


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def _mlp(layers, x: torch.Tensor, precision: str) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = _mm(x, layer["w"].float(), precision) + layer["b"].float()
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def bags(model, seed: int, indices: torch.Tensor) -> torch.Tensor:
    """(B, n_tables, L) logical ids -> (B, n_tables, D) float32 bags, each
    added in float32 and rounded once to the tables' dtype."""
    b, n_t, n_l = indices.shape
    out = torch.empty((b, n_t, model.embed_dim), dtype=torch.float32,
                      device=indices.device)
    for t in range(n_t):
        ids = indices[:, t, :].reshape(-1).to(torch.int64)
        uniq, inv = torch.unique(ids, return_inverse=True)
        rows = table_rows(seed, t, uniq, model.embed_dim, model.table_scale,
                          model.table_dtype).float()
        bag = rows[inv].view(b, n_l, -1).sum(1)
        out[:, t] = bag.to(model.table_dtype).float()
    return out


def logits(model, weights: dict, seed: int, dense: torch.Tensor,
           indices: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """Logits (B,) float32 of samples ``dense`` (B, n_dense) and
    ``indices`` (B, n_tables, L), on their device, in blocks of
    ``BLOCK``."""
    if precision not in ("float32", "tf32", "tf32-card"):
        raise ValueError(f"unknown precision {precision!r}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32-card"
    try:
        outs = []
        n = model.n_tables + 1
        iu, ju = torch.triu_indices(n, n, 1, device=dense.device)
        for s in range(0, dense.shape[0], BLOCK):
            x = _mlp(weights["bot"], dense[s:s + BLOCK].float(), precision)
            z = torch.cat([x[:, None, :],
                           bags(model, seed, indices[s:s + BLOCK])], dim=1)
            zt = z.transpose(1, 2)
            if precision == "tf32":
                z, zt = round_tf32(z), round_tf32(zt)
            gram = torch.bmm(z, zt)
            feat = torch.cat([x, gram[:, iu, ju]], dim=1)
            outs.append(_mlp(weights["top"], feat, precision)[:, 0])
        return torch.cat(outs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
