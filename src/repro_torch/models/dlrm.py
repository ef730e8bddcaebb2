"""DLRM (Naumov et al., arXiv:1906.00091) on torch tensors.

dense features -> bottom MLP -> d-dim vector; each sparse field -> SLS
(embedding-bag sum) -> d-dim vector; pairwise-dot interaction over the
(n_tables + 1) vectors; concat [bottom_out, interactions] -> top MLP -> CTR
logit. Port of ``repro.models.dlrm`` (``DLRMConfig``, ``make_rmc`` and the
paper's RMC1-3, ``init``, ``interact``, ``forward``, ``loss``,
``add_remap``, ``retrieval_score``, with their mesh branches).

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

A bf16 model runs as the reference's does: bags in the tables' dtype (added
in float32, rounded once), the interaction in the dtype JAX promotes the
bottom MLP's output and the bags to, and the MLPs likewise
(``models.common.dense``). With bf16 dense features everything after the
inputs is bf16, the logits too; with float32 dense features on bf16
weights the bottom MLP, the interaction and the logits are float32, as in
the reference.

Ids out of range are clamped on every single-device route (the kernels and
their plain versions): an id into [0, V) before the ``rank_of``
translation, a rank into [0, V). The reference's ``jnp.take`` fills
instead: -1 reads row V-1 and an id at or past V gives NaN logits. The mesh
route follows the reference's ``shard_map`` bodies
(``embedding.sharded``).

Under a mesh (``mesh=``, a ``repro_torch.distributed.mesh.Mesh``) each
rank runs the reference's ``shard_map`` bodies on its blocks: ``params``
hold this rank's rows of each table (and of each ``rank_of``), ``batch``
this rank's rows of the batch, and the outputs are this rank's block. The
bags are the row-sharded masked-psum SLS of ``repro_torch.embedding.
sharded`` (plain PyTorch gathers and NCCL or gloo collectives), one table
at a time as the reference does; the interaction is still one fused
launch on the rank's rows.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import out_boundary, psum
from repro_torch.distributed.shardings import P
from repro_torch.embedding.layout import lookup
from repro_torch.embedding.sharded import (sharded_embedding_bag,
                                           sharded_embedding_bag_2d,
                                           sharded_remapped_bag)
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.recflash_sls import describe
from repro_torch.models.common import (bce_with_logits, make_generator, mlp,
                                       mlp_init, uniform_init)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_tables: int
    n_dense: int
    embed_dim: int
    n_rows: tuple           # per-table vocab sizes (len == n_tables)
    lookups: int            # multi-hot width per table
    bot_mlp: tuple          # hidden sizes; input = n_dense, output = embed_dim
    top_mlp: tuple          # hidden sizes; output = 1
    interaction: str = "dot"

    @property
    def n_vectors(self) -> int:
        return self.n_tables + 1

    @property
    def top_in(self) -> int:
        if self.interaction == "dot":
            n = self.n_vectors
            return self.embed_dim + n * (n - 1) // 2
        return self.n_vectors * self.embed_dim    # concat interaction

    def flops_per_sample(self) -> int:
        """MODEL_FLOPS estimate (fwd): 2*MACs of MLPs + interaction + SLS."""
        f = 0
        sizes = (self.n_dense,) + tuple(self.bot_mlp) + (self.embed_dim,)
        f += sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:], strict=True))
        tsizes = (self.top_in,) + tuple(self.top_mlp) + (1,)
        f += sum(2 * a * b for a, b in zip(tsizes[:-1], tsizes[1:], strict=True))
        f += 2 * self.n_vectors * self.n_vectors * self.embed_dim  # pairwise dot
        f += 2 * self.n_tables * self.lookups * self.embed_dim     # SLS adds
        return f


def make_rmc(name: str, n_tables: int, dim: int, lookups: int,
             bot: tuple, top: tuple, n_rows: int = 1_000_000,
             n_dense: int | None = None) -> DLRMConfig:
    """Table-II helper: sizes listed as `in-h1-..` for bottom, `h..-1` top."""
    return DLRMConfig(name=name, n_tables=n_tables,
                      n_dense=n_dense if n_dense is not None else bot[0],
                      embed_dim=dim, n_rows=(n_rows,) * n_tables,
                      lookups=lookups, bot_mlp=tuple(bot[1:-1]) + (bot[-1],),
                      top_mlp=tuple(top[:-1]))


# Table II (paper) — bottom lists include input dim, tops end with 1.
RMC1 = make_rmc("rmc1", 8, 32, 80, (128, 64, 32), (256, 64, 1))
RMC2 = make_rmc("rmc2", 32, 64, 120, (256, 128, 64), (128, 64, 1))
RMC3 = make_rmc("rmc3", 10, 32, 20, (2560, 1024, 256, 32), (512, 256, 1))


def init(seed: int, cfg: DLRMConfig, dtype=torch.float32,
         device: str | torch.device = "cuda") -> dict:
    """Random parameters with the reference's distributions, drawn on
    ``device`` from a generator seeded with ``seed`` (the draws differ from
    JAX's; transplant reference weights with ``repro_torch.weights``)."""
    gen = make_generator(seed, resolve_device(device))
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
    """bottom_out (B,D), bags (B,T,D) -> top-MLP input, in the dtype the two
    promote to (the reference's concatenate). The dot interaction is one
    fused-interaction launch: [bottom_out, upper-triangle dots]."""
    dt = torch.promote_types(bottom_out.dtype, bags.dtype)
    bottom_out, bags = bottom_out.to(dt), bags.to(dt)
    if interaction == "dot":
        fused = ref.dot_interaction_fused_ref if plain else \
            ops.dot_interaction_fused
        return fused(bottom_out, bags)                     # (B, D + nC2)
    z = torch.cat([bottom_out[:, None, :], bags], dim=1)          # (B,T+1,D)
    return z.reshape(z.shape[0], -1)


def _bag(params, indices: torch.Tensor, t: int, mesh=None, axes=("data",),
         hybrid: bool = False, table_2d: bool = False,
         plain: bool = False) -> torch.Tensor:
    """One table's SLS. Without a mesh: over its stored table, split at its
    hot size, a per-table launch with the ids translated by a gather before
    it (``forward`` takes all tables at once, ``bags``).

    With remap enabled (``rank_of`` present) logical ids are first
    translated to ranks on the device (the paper's hash table). A table
    without a remap is served as ``RemapSpec.identity`` would: hot size 1.

    Under a mesh: the sharded masked-psum SLS on this rank's rows, through
    the two-phase translation when remapped. ``axes=None`` means indices
    replicated over the data axes (the batch-1 user side of retrieval).
    ``hybrid=True`` finishes with a reduce-scatter: the bags come back with
    the batch split over (axes x model). ``table_2d=True`` shards the table
    rows over (model x data) as well.
    """
    if mesh is not None:
        table, ro = params["tables"][t], params.get("rank_of")
        if table_2d and axes is not None:
            return sharded_embedding_bag_2d(
                table, indices, ro[t] if ro else None, mesh=mesh)
        if ro is not None:
            return sharded_remapped_bag(table, ro[t], indices, "model",
                                        scatter=hybrid, mesh=mesh)
        return sharded_embedding_bag(table, indices, "model", scatter=hybrid,
                                     mesh=mesh)
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
    int32 logical ids -> (B, n_tables, D) in the tables' dtype, each bag
    added in float32; an id out of range is clamped (module docstring).

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


def _constrain_hybrid(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's rows of ``x``, the rank's block over ``axes``: its
    ``model`` chunk, where the reduce-scatter over the model axis leaves the
    bags (``P(axes + ("model",))``)."""
    n = mesh.axis_size("model")
    if x.shape[0] % n:
        raise ValueError(f"the hybrid layout splits the {x.shape[0]} rows "
                         f"of this rank's batch over {n} model ranks: not "
                         "divisible")
    return x.chunk(n)[mesh.axis_index("model")]


def forward(params, batch, cfg: DLRMConfig, mesh=None, axes=("data",),
            hybrid: bool = False, table_2d: bool = False,
            plain: bool = False) -> torch.Tensor:
    """batch: dense (B,n_dense) f32 (or the params' dtype), indices
    (B,n_tables,lookups) int32 -> logits (B,).

    An id outside [0, V) is clamped into it; the reference's forward gives
    row V-1 for -1 and NaN logits for an id at or past V (``jnp.take``'s
    fill mode). The logits' dtype is the reference's (module docstring).

    Under a mesh, ``hybrid`` splits the batch across (axes x model) for the
    dense path (bottom/top MLP and interaction): the bags' all-reduce
    becomes a reduce-scatter and the dense compute uses every rank instead
    of running model-ways replicated; ``table_2d`` (with ``hybrid``) takes
    the 2D row-sharded tables.

    Under a torch profiler the call is the span ``obs.FORWARD``, holding
    ``obs.BOT_MLP``, ``obs.BAGS``, ``obs.INTERACT`` (the bags' cast to the
    interaction's dtype included) and ``obs.TOP_MLP`` (``repro_torch.obs``).
    """
    with obs.span(obs.FORWARD):
        hybrid = hybrid and mesh is not None and axes is not None
        dense_in = batch["dense"]
        if hybrid:
            dense_in = _constrain_hybrid(dense_in, mesh, axes)
        with obs.span(obs.BOT_MLP):
            x = mlp(params["bot"], dense_in)
        with obs.span(obs.BAGS):
            if mesh is None:
                all_bags = bags(params, batch["indices"], plain)
            else:
                all_bags = torch.stack(
                    [_bag(params, batch["indices"][:, t, :], t, mesh, axes,
                          hybrid, table_2d=hybrid and table_2d)
                     for t in range(cfg.n_tables)], dim=1)
        with obs.span(obs.INTERACT):
            feat = interact(x, all_bags, cfg.interaction, plain)
        with obs.span(obs.TOP_MLP):
            return mlp(params["top"], feat)[:, 0]          # logits (B,)


def loss(params, batch, cfg: DLRMConfig, mesh=None, axes=("data",),
         hybrid: bool = False, table_2d: bool = False,
         plain: bool = False) -> torch.Tensor:
    """Mean binary cross-entropy of the CTR logits against ``labels``
    (``models.common.bce_with_logits``: the reference's formula and its
    gradient at a zero logit).

    Under a mesh it is the mean over the global batch, on every rank. Its
    gradients are those of ``jax.grad`` under ``shard_map``'s rules: after
    ``shardings.sync_grads`` over the params' specs, each rank holds its
    block of the reference's gradient.
    """
    logits = forward(params, batch, cfg, mesh, axes, hybrid, table_2d,
                     plain)
    y = batch["labels"]
    hybrid = hybrid and mesh is not None and axes is not None
    if hybrid:
        y = _constrain_hybrid(y, mesh, axes)
    per = bce_with_logits(logits, y)
    if mesh is None:
        return torch.mean(per)
    # the logits' rows are split over the batch axes (and model when
    # hybrid) and replicated over the rest: summed over every rank, each
    # row counts once per replica
    row_axes = () if axes is None else \
        tuple(axes) + (("model",) if hybrid else ())
    reps = mesh.axis_size([a for a in mesh.axis_names if a not in row_axes])
    part = per.sum() / (per.shape[0] * mesh.axis_size(row_axes))
    return out_boundary(psum(part, mesh, mesh.axis_names) / reps, mesh, P())


def retrieval_score(params, batch, cfg: DLRMConfig, mesh=None,
                    axes=("data",), plain: bool = False) -> torch.Tensor:
    """Score 1 user against N candidates (the retrieval_cand shape).

    batch: dense (1, n_dense), indices (1, n_tables, lookups), candidates
    (N,) logical ids of the last table. The user's dense path and fixed
    fields are computed once: one grouped SLS launch over every table (its
    last bag dropped). The candidates' field is one per-table SLS launch of
    (N, 1) bags, after the rank_of gather. Then one fused interaction over
    the N rows, the user's bottom output broadcast (stride 0), and the top
    MLP. Returns (N,) logits.

    Under a mesh the user's fields are sharded bags of replicated indices,
    one table at a time, and ``candidates`` are this rank's block over
    ``axes``; returns this rank's block of the scores.
    """
    x = mlp(params["bot"], batch["dense"])                       # (1, D)
    if mesh is None:
        fixed = bags(params, batch["indices"], plain)[:, :-1]     # (1, T-1, D)
    else:
        fixed = torch.stack([_bag(params, batch["indices"][:, t, :], t,
                                  mesh, None)
                             for t in range(cfg.n_tables - 1)], dim=1)
    cand = _bag(params, batch["candidates"][:, None], cfg.n_tables - 1,
                mesh, axes, plain=plain)                         # (N, D)
    n = cand.shape[0]
    # the N rows of bags in the interaction's dtype at once (not in the
    # tables' and again in that one: dlrm-mlperf's are 6.9 GB in bf16)
    dt = torch.promote_types(x.dtype, cand.dtype)
    all_bags = torch.cat([fixed.to(dt).expand(n, -1, -1),
                          cand[:, None, :].to(dt)], dim=1)
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
    checking a wider one reads its maximum back from the device. Tables of
    a dtype the kernel does not take (float64, for a float64 oracle) get no
    descriptors: only the plain route serves them.
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
    desc = (describe(params["tables"], hot, rank_of)
            if params["tables"][0].dtype in _build.DTYPE_CODES else None)
    return {**params, "rank_of": rank_of, "hot_sizes": hot,
            "sls_desc": desc}
