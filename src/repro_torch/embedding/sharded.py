"""Distributed embedding lookup: row-sharded tables and masked-psum bags
(port of ``repro.embedding.sharded``).

Each function is the body the reference runs inside ``shard_map``, run once
per rank on the rank's blocks, with an explicit ``mesh``
(``repro_torch.distributed.mesh``) in place of the JAX mesh's named axes:

  * each "model" rank holds ``V / M`` contiguous stored rows;
  * every rank translates the (replicated-over-model) indices to its local
    range, gathers with clamping and zeroes the rows it does not own;
  * the pooled bag is summed over the model axis (``all_reduce``), or
    reduce-scattered over the batch (``reduce_scatter_tensor``, the hybrid
    layout) — the collectives carry ``batch x dim``, never the table.

With ``RemapSpec(plane_distribute=True)`` the hot rows are striped across
shards, so the partial bags are balanced (the paper's plane-parallel SLS at
shard granularity). The rank-local masked gather is plain PyTorch, as the
reference's is ``jnp.take`` outside any Pallas kernel.

The collectives are differentiable (``repro_torch.distributed.mesh``), so a
table block's gradient is the block of the reference's ``jax.grad`` once
``shardings.sync_grads`` has summed it over the axes the table is
replicated on.

``row_parallel_lookup`` and ``vocab_parallel_nll`` are the vocab-parallel
pair of the models whose activations stay replicated over ``model``
(Megatron's layout: the LM's embedding and loss, DIN's and BERT4Rec's item
tables): a masked lookup and a logsumexp across vocab blocks, summed by
``reduce_from``, so that every ``model`` rank holds the whole cotangent.
They clamp an id into the table first, the single-device contract.

Ids out of range in the bags follow the reference's ``shard_map``
bodies, not the single-device routes' clamp (``embedding.layout.lookup``).
An id below 0 or at or past V is owned by no shard, so (read on 2 gloo
ranks):

  * without a remap (``sharded_embedding_bag``, and the 2D bag without
    ``rank_of``) every rank zeroes its row: the bag leaves that id out;
  * through the two-phase remap (``sharded_remapped_bag``, the 2D bag with
    ``rank_of``) every rank translates it to rank 0, so it reads stored row
    0, the hottest row.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.mesh import (Mesh, all_gather, pmax, psum,
                                          psum_scatter, reduce_from,
                                          shard_map)
from repro_torch.embedding.layout import lookup


def local_shard_lookup(local_table: torch.Tensor, indices: torch.Tensor,
                       shard_id: int, rows_per_shard: int) -> torch.Tensor:
    """Gather ``indices`` (stored-rank space) from this shard's rows.

    Returns (..., L, D) with rows owned by other shards zeroed.
    """
    local = indices - shard_id * rows_per_shard
    ok = (local >= 0) & (local < rows_per_shard)
    clamped = torch.clamp(local, 0, rows_per_shard - 1)
    vecs = torch.index_select(local_table, 0, clamped.reshape(-1))
    vecs = vecs.reshape(*clamped.shape, local_table.shape[-1])
    return torch.where(ok[..., None], vecs, vecs.new_zeros(()))


def row_parallel_lookup(block: torch.Tensor, ids: torch.Tensor,
                        mesh: Mesh | None, axis: str = "model"
                        ) -> torch.Tensor:
    """The rows of a table row-sharded over ``axis`` at global ``ids``
    (any shape), whole on every rank of ``axis``: ``block`` is this rank's
    ``(n_rows / n, ...)`` rows. Each id is clamped into the table first
    (the port's one contract, ``embedding.layout.lookup``), then shifted
    to the block, and a row the rank does not own is zeroed; the rows are
    summed over ``axis`` by ``reduce_from`` (the vocab-parallel embedding:
    its cotangent reaches each rank whole, so a block's gradient is the
    rank's own rows' share). No shortcut at one rank: there the sum is
    over the one block. Without a mesh ``block`` is the whole table."""
    if mesh is None:
        return lookup(block, ids)
    n_loc = block.shape[0]
    local = ids.clamp(0, n_loc * mesh.axis_size(axis) - 1) \
        - mesh.axis_index(axis) * n_loc
    rows = lookup(block, local)
    rows = torch.where(((local >= 0) & (local < n_loc))[..., None], rows, 0)
    return reduce_from(rows, mesh, axis)


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """The NLL of ``targets`` (global ids, any shape) under logits whose
    last dim is this rank's block of a vocab split over ``axis``: the
    logsumexp across the blocks (the max by ``pmax``, the sum of exps by
    ``reduce_from``) less the target's logit, taken on the rank that owns
    the target (the target clamped into the vocab as an id is) and summed
    over ``axis``. Same shape as ``targets``, whole on every rank."""
    n_loc = logits.shape[-1]
    m = pmax(logits.amax(-1, keepdim=True), mesh, axis)
    lse = m[..., 0] + torch.log(reduce_from(
        torch.exp(logits - m).sum(-1), mesh, axis))
    local = targets.long().clamp(0, n_loc * mesh.axis_size(axis) - 1) \
        - mesh.axis_index(axis) * n_loc
    own = (local >= 0) & (local < n_loc)
    tl = logits.gather(-1, local.clamp(0, n_loc - 1)[..., None])[..., 0]
    return lse - reduce_from(torch.where(own, tl, 0.0), mesh, axis)


def _pool(vecs: torch.Tensor, bag: int, mode: str) -> torch.Tensor:
    if mode == "sum":
        return vecs.sum(dim=-2)
    if mode == "mean":
        return vecs.sum(dim=-2) / bag
    raise ValueError(f"unsupported distributed mode {mode!r}")


def sharded_embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                          axis_name, mode: str = "sum",
                          scatter: bool = False, *, mesh: Mesh
                          ) -> torch.Tensor:
    """SLS over a row-sharded table, on this rank's blocks.

    ``table`` is the local shard (rows_per_shard, D); ``indices`` is
    (..., L) in stored-rank space, identical on every rank of
    ``axis_name``. Output (..., D) is fully reduced (every rank gets the
    pooled bags).

    ``scatter=True`` finishes with a reduce-scatter over the leading
    (batch) dim instead: each model rank keeps its 1/M slice of the batch,
    half the wire of an all-reduce, and everything dense downstream then
    runs batch-split across the model axis too (the hybrid layout).
    """
    rows_per_shard = table.shape[0]
    shard_id = mesh.axis_index(axis_name)
    vecs = local_shard_lookup(table, indices, shard_id, rows_per_shard)
    pooled = _pool(vecs, indices.shape[-1], mode)
    if scatter:
        return psum_scatter(pooled, mesh, axis_name)
    return psum(pooled, mesh, axis_name)


def make_sharded_bag(mesh: Mesh, table_spec, index_spec, out_spec,
                     axis_name: str = "model", mode: str = "sum"):
    """``sharded_embedding_bag`` under the port's ``shard_map``: the
    returned function takes the global table and indices and returns this
    rank's block of the bags."""

    def fn(table, indices):
        return sharded_embedding_bag(table, indices, axis_name, mode,
                                     mesh=mesh)

    return shard_map(fn, mesh=mesh, in_specs=(table_spec, index_spec),
                     out_specs=out_spec)


def sharded_embedding_bag_2d(table: torch.Tensor, indices: torch.Tensor,
                             rank_of: torch.Tensor | None = None,
                             model_axis: str = "model",
                             data_axis: str = "data",
                             mode: str = "sum", *, mesh: Mesh
                             ) -> torch.Tensor:
    """SLS over a 2D row-sharded table: rows split over (model x data).

    Sharding rows over both axes gives every row exactly one owner: no
    gradient replication across data, and the only collectives are an
    index all-gather and the bags' reduce-scatter.

    ``table`` (V/(M*D), dim) local rows, the block ``P(("model", "data"))``
    gives this rank; ``indices`` (B/D, L) this data rank's batch; optional
    ``rank_of`` (V/(M*D),) the local slice of the logical->rank hash table
    (two-phase remapped lookup). Returns (B/(D*M), dim): the batch
    scattered over (data, model), the hybrid layout the dense path takes.

    The row owner is numbered model-major (``model * n_data + data``) and
    the batch chunks data-major, as in the reference; both come from mesh
    coordinates, not from a process group's rank order.
    """
    rows_per_shard = table.shape[0]
    idx_full = all_gather(indices, mesh, data_axis)
    sid = (mesh.axis_index(model_axis) * mesh.axis_size(data_axis)
           + mesh.axis_index(data_axis))
    if rank_of is not None:
        # phase 1: logical id -> stored rank through the sharded hash table
        local = idx_full - sid * rows_per_shard
        ok = (local >= 0) & (local < rows_per_shard)
        clamped = torch.clamp(local, 0, rows_per_shard - 1)
        ranks = torch.where(ok, rank_of[clamped], 0).to(idx_full.dtype)
        idx_full = psum(ranks, mesh, (data_axis, model_axis))
    vecs = local_shard_lookup(table, idx_full, sid, rows_per_shard)
    pooled = _pool(vecs, indices.shape[-1], mode)
    return psum_scatter(pooled, mesh, (data_axis, model_axis))


def sharded_remapped_bag(table: torch.Tensor, rank_of: torch.Tensor,
                         indices: torch.Tensor, axis_name, mode: str = "sum",
                         scatter: bool = False, *, mesh: Mesh
                         ) -> torch.Tensor:
    """Frequency-remapped SLS with a sharded hash table (two-phase).

    The paper's FTL hash-table lookup at shard granularity: the
    logical->rank translation (``rank_of``, the hash table) is itself
    row-sharded; each rank translates the ids it owns and a small integer
    all-reduce assembles the rank vector, then the rank-space masked-psum
    SLS runs as usual. Nothing table-sized moves.

    ``table`` (rows/shard, D) is stored rank-ordered; ``rank_of``
    (rows/shard,) holds the ranks of this shard's logical id range.
    """
    rows_per_shard = rank_of.shape[0]
    shard_id = mesh.axis_index(axis_name)
    local = indices - shard_id * rows_per_shard
    ok = (local >= 0) & (local < rows_per_shard)
    clamped = torch.clamp(local, 0, rows_per_shard - 1)
    ranks = torch.where(ok, rank_of[clamped], 0).to(indices.dtype)
    ranks = psum(ranks, mesh, axis_name)         # phase 1: translate
    return sharded_embedding_bag(table, ranks, axis_name, mode,
                                 scatter=scatter, mesh=mesh)
