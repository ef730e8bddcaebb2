"""DLRM (Naumov et al., arXiv:1906.00091) on torch tensors, single device.

dense features -> bottom MLP -> d-dim vector; each sparse field -> SLS
(embedding-bag sum) -> d-dim vector; pairwise-dot interaction over the
(n_tables + 1) vectors; concat [bottom_out, interactions] -> top MLP -> CTR
logit. Port of ``repro.models.dlrm`` (``init``, ``interact``, ``forward``,
``loss``, ``add_remap``, ``retrieval_score``; the mesh branches wait).

Unlike the reference forward, which takes bags with ``jnp.take`` and the
interaction with an einsum, this forward routes both through the port's
kernels, one launch each per batch: the grouped two-tier SLS reads every
table's bags over the hot prefix and the cold tail of its stored table,
translating logical ids through ``rank_of`` inside the kernel, and the fused
interaction writes the top-MLP input. The function is the same; the sums
differ only in their order. ``plain=True`` routes them through the kernels'
plain versions instead (the oracle on the card). The MLPs stay
``torch.matmul``, as the reference leaves them to XLA.

When a gradient is wanted (grad mode on and parameters that require one),
both launches go through their ``autograd.Function`` (``kernels.ops``):
the forward is still the kernel, the backward plain PyTorch, and each stored
table gets the dense (V, D) gradient ``jax.grad`` gives the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs import DLRMConfig
from repro_torch.device import resolve_device
from repro_torch.embedding.layout import lookup
from repro_torch.kernels import ops, ref
from repro_torch.kernels.recflash_sls import describe
from repro_torch.models.common import mlp, mlp_init, uniform_init


def init(seed: int, cfg: DLRMConfig, dtype=torch.float32,
         device: str | torch.device = "cuda") -> dict:
    """Random parameters with the reference's distributions, drawn on
    ``device`` from a generator seeded with ``seed`` (the draws differ from
    JAX's; transplant reference weights with ``repro_torch.weights``)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    tables = [uniform_init(gen, (n, cfg.embed_dim), 1.0 / math.sqrt(n), dtype)
              for n in cfg.n_rows]
    bot_sizes = (cfg.n_dense,) + tuple(cfg.bot_mlp)
    if bot_sizes[-1] != cfg.embed_dim:
        bot_sizes = bot_sizes + (cfg.embed_dim,)
    top_sizes = (cfg.top_in,) + tuple(cfg.top_mlp) + (1,)
    return {
        "tables": tables,
        "bot": mlp_init(gen, bot_sizes, dtype),
        "top": mlp_init(gen, top_sizes, dtype),
    }


def interact(bottom_out: torch.Tensor, bags: torch.Tensor, interaction: str,
             plain: bool = False) -> torch.Tensor:
    """bottom_out (B,D), bags (B,T,D) -> top-MLP input. The dot interaction
    is one fused-interaction launch: [bottom_out, upper-triangle dots]."""
    if interaction == "dot":
        fused = ref.dot_interaction_fused_ref if plain else \
            ops.dot_interaction_fused
        return fused(bottom_out, bags)                     # (B, D + nC2)
    z = torch.cat([bottom_out[:, None, :], bags], dim=1)          # (B,T+1,D)
    return z.reshape(z.shape[0], -1)


def _bag(params, indices: torch.Tensor, t: int,
         plain: bool = False) -> torch.Tensor:
    """One table's SLS over its stored table, split at its hot size: a
    per-table launch, with the ids translated by a gather before it.
    ``forward`` takes all tables at once (``bags``).

    With remap enabled (``rank_of`` present) logical ids are first
    translated to ranks on the device (the paper's hash table). A table
    without a remap is served as ``RemapSpec.identity`` would: hot size 1.
    """
    stored = params["tables"][t]
    if "rank_of" in params:
        idx = lookup(params["rank_of"][t], indices)
        hot = params["hot_sizes"][t]
    else:
        idx = indices.to(torch.int32).contiguous()
        hot = 1
    if plain:
        return ref.recflash_sls_ref(stored[:hot], stored[hot:], idx)
    # block_b only constrains B on the TPU; the CUDA kernel takes any B
    return ops.recflash_sls(stored[:hot], stored[hot:], idx, block_b=1)


def bags(params, indices: torch.Tensor, plain: bool = False
         ) -> torch.Tensor:
    """Every table's SLS in one grouped launch: indices (B, n_tables, L)
    int32 logical ids -> (B, n_tables, D) f32.

    With remap enabled the kernel translates ids through each ``rank_of``
    and reads the descriptors ``add_remap`` built; tables without a remap
    are served with hot size 1, their descriptors built per call.
    """
    rank_of = params.get("rank_of")
    hot = (params["hot_sizes"] if rank_of is not None
           else [1] * len(params["tables"]))
    if plain:
        return ref.recflash_sls_grouped_ref(params["tables"], hot, indices,
                                            rank_of)
    return ops.recflash_sls_grouped(params["tables"], hot, indices, rank_of,
                                    params.get("sls_desc"))


def forward(params, batch, cfg: DLRMConfig, plain: bool = False
            ) -> torch.Tensor:
    """batch: dense (B,n_dense) f32, indices (B,n_tables,lookups) int32."""
    x = mlp(params["bot"], batch["dense"])
    feat = interact(x, bags(params, batch["indices"], plain),
                    cfg.interaction, plain)
    return mlp(params["top"], feat)[:, 0]          # logits (B,)


def loss(params, batch, cfg: DLRMConfig, plain: bool = False
         ) -> torch.Tensor:
    """Mean binary cross-entropy of the CTR logits against ``labels``,
    written as the reference writes it (``max(l, 0) - l*y +
    log1p(exp(-|l|))``), not as ``F.binary_cross_entropy_with_logits``,
    whose rounding differs."""
    logits = forward(params, batch, cfg, plain)
    y = batch["labels"]
    return torch.mean(torch.maximum(logits, logits.new_zeros(()))
                      - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def retrieval_score(params, batch, cfg: DLRMConfig, plain: bool = False
                    ) -> torch.Tensor:
    """Score 1 user against N candidates (the retrieval_cand shape).

    batch: dense (1, n_dense), indices (1, n_tables, lookups), candidates
    (N,) logical ids of the last table. The user's dense path and fixed
    fields are computed once: one grouped SLS launch over every table (its
    last bag dropped). The candidates' field is one per-table SLS launch of
    (N, 1) bags, after the rank_of gather. Then one fused interaction over
    the N rows, the user's bottom output broadcast (stride 0), and the top
    MLP. Returns (N,) logits.
    """
    x = mlp(params["bot"], batch["dense"])                       # (1, D)
    fixed = bags(params, batch["indices"], plain)[:, :-1]         # (1, T-1, D)
    cand = _bag(params, batch["candidates"][:, None], cfg.n_tables - 1,
                plain)                                           # (N, D)
    n = cand.shape[0]
    all_bags = torch.cat([fixed.expand(n, -1, -1), cand[:, None, :]], dim=1)
    feat = interact(x.expand(n, -1), all_bags, cfg.interaction, plain)
    return mlp(params["top"], feat)[:, 0]                        # (N,)


def add_remap(params, rank_ofs, hot_sizes=None) -> dict:
    """Attach per-table logical->rank hash tables (RecFlash layout) and the
    hot size that splits each stored table into its two tiers.

    ``rank_ofs`` are (V,) arrays or tensors, kept as int32 on the tables'
    device; ``hot_sizes`` defaults to 1 per table. Also builds the grouped
    SLS kernel's table descriptors (``sls_desc``); the kernel's wrapper
    refuses them after a table, hot size or rank_of is replaced, so a
    training step, whose optimizer returns new tables, calls this every
    step. An int32 tensor is taken as it is: it cannot be out of range, and
    checking a wider one reads its maximum back from the device.
    """
    device = params["tables"][0].device
    rank_of = []
    for r in rank_ofs:
        r = torch.as_tensor(r)
        if r.dtype != torch.int32 and r.numel() and int(r.max()) >= 2**31:
            raise ValueError("rank_of does not fit in int32")
        rank_of.append(r.to(device=device, dtype=torch.int32).contiguous())
    hot = [1] * len(rank_of) if hot_sizes is None else list(map(int,
                                                                hot_sizes))
    if len(hot) != len(rank_of):
        raise ValueError("need one hot size per rank_of table")
    return {**params, "rank_of": rank_of, "hot_sizes": hot,
            "sls_desc": describe(params["tables"], hot, rank_of)}
