"""A plain PyTorch reference of MLPerf's DLRM-DCNv2 forward, which the
port's ``models.dlrm`` is held to (the JAX reference has no DCN).

It imports neither jax nor any module of the port: the logits are written
out here from the published model, TorchRec's ``DLRM_DCN``
(mlcommons/training ``recommendation_v2/torchrec_dlrm``), in float32 with
TF32 off, over the logical tables (no remap, no ``rank_of``, no kernel).

    bottom = MLP(dense)                      # ReLU between layers
    bag_t  = sum of table t's rows at its ids, in lookup order
    x0     = [bottom; bag_0; ...; bag_{T-1}]  # (B, (T + 1) D)
    x      = x0 * (x @ v_l @ w_l + b_l) + x   # each cross layer, from x = x0
    logits = MLP(x)[:, 0]                    # ReLU between layers

Where it departs from TorchRec's ``DLRM_DCN``, as the port does:

- the bottom MLP's last layer has no ReLU (TorchRec's ``DenseArch`` puts
  one after every layer): the port's DLRM keeps the JAX reference's
  ``mlp``, which the dot-interaction DLRMs share;
- weights are (d_in, d_out), used as ``x @ w``: ``v`` and ``w`` are the
  transposes of ``LowRankCrossNet``'s ``V_kernels`` and ``W_kernels``,
  and the MLPs' weights those of ``nn.Linear``;
- a bag of bf16 rows is added in float32 and rounded once to bf16, then
  widened again (the port's tables are bf16 at full size; TorchRec's are
  float32);
- no sigmoid: the logits, as the port returns them;
- weights and ids come from the caller; nothing here initialises.
"""

from __future__ import annotations

import torch


def mlp(layers, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` a layer in float32, ReLU between layers."""
    for i, layer in enumerate(layers):
        x = x @ layer["w"].float() + layer["b"].float()
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def bags(tables, indices: torch.Tensor, lookups) -> torch.Tensor:
    """(B, sum(lookups)) logical ids, table t's in its own ``lookups[t]``
    columns -> (B, T, D) float32: each bag's rows added in float32 in
    lookup order and rounded once to the tables' dtype."""
    out, col = [], 0
    for table, n in zip(tables, lookups, strict=True):
        rows = table[indices[:, col:col + n].long()].float()    # (B, n, D)
        acc = torch.zeros_like(rows[:, 0])
        for j in range(n):
            acc = acc + rows[:, j]
        out.append(acc.to(table.dtype).float())
        col += n
    return torch.stack(out, dim=1)


def cross(layers, x0: torch.Tensor) -> torch.Tensor:
    """TorchRec's ``LowRankCrossNet``: x = x0 * (W (V x) + b) + x a layer,
    from x = x0."""
    x = x0
    for layer in layers:
        x = x0 * ((x @ layer["v"].float()) @ layer["w"].float()
                  + layer["b"].float()) + x
    return x


def logits(params, dense: torch.Tensor, indices: torch.Tensor,
           lookups) -> torch.Tensor:
    """The forward's logits (B,) float32 of ``params`` (logical
    ``tables``, ``bot``, ``cross`` and ``top`` layers as the port holds
    them) on dense features (B, n_dense) and ragged ids (B,
    sum(lookups))."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = mlp(params["bot"], dense.float())
        z = torch.cat([x[:, None, :], bags(params["tables"], indices,
                                           lookups)], dim=1)
        x = cross(params["cross"], z.reshape(z.shape[0], -1))
        return mlp(params["top"], x)[:, 0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
