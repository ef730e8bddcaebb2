"""Shared plumbing for the recsys and GNN archs (port of
``repro.configs.recsys_common``).

Cells per recsys arch: train_batch (a 65,536-sample train step with the
partitioned optimizer: row-wise adagrad on tables, AdamW on the MLPs),
serve_p99 (512), serve_bulk (262,144), retrieval_cand (1 user x 1M
candidates).

A plan follows the port's convention (``lm_common``): its ``args`` are
full-size tensors on the ``meta`` device, and its ``fn`` runs on this
rank's block of each (``CellPlan.local_specs``). Every arch holds the
reference's blocks. The DLRM archs take theirs as the reference's
``shard_map`` bodies do: the tables row-sharded over ``model`` with the
masked-psum SLS, the ``rank_of`` hash tables sharded beside them and
consulted through the two-phase translation (``models.dlrm``); the loss's
cotangent is divided over the whole mesh and each gradient summed over the
axes its spec leaves out (``shardings.sync_grads``), as
``shard_map(check_vma=False)`` sums it. DIN's and BERT4Rec's item tables
are row-sharded over ``model`` too, in Megatron's way (``models.din``,
``models.bert4rec``: a masked lookup summed by ``reduce_from``, BERT4Rec's
tied output on the rank's vocab block behind ``in_boundary``): every
``model`` rank holds the whole cotangent of the replicated activations, so
the loss's cotangent is divided over the batch axes only and each gradient
is summed over the batch axes its spec leaves out (``megatron=True``).
GraphSAGE's weights are replicated: each rank runs its block of the batch,
its loss is the whole batch's (``data_parallel_mean``). Non-trainable
buffers (``rank_of``) ride in the batch, outside the differentiated
params.

Plan functions take ``(params, batch, mesh, axes)``; a plan built with
``plain=True`` passes ``plain=True`` too, which routes the DLRM's kernels
through their plain versions (the oracle on the card); the other models
reach no kernel and take no ``plain``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import optim, tree
from repro_torch.configs.lm_common import CellPlan, bt_axes
from repro_torch.distributed.mesh import out_boundary, psum
from repro_torch.distributed.shardings import P, make_param_specs, sync_grads

RECSYS_SHAPES = {
    "train_batch": dict(batch=65_536),
    "serve_p99": dict(batch=512),
    "serve_bulk": dict(batch=262_144),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000),
}


def recsys_optimizer():
    """Row-wise adagrad on ``tables`` and ``items``, AdamW elsewhere."""
    return optim.partitioned(
        lambda ks: "table" if ("tables" in ks or "items" in ks) else "dense",
        {"table": optim.adagrad(0.01, rowwise=True),
         "dense": optim.adamw(1e-3)})


def recsys_opt_rules(param_rules):
    """Optimizer-state rules: row-wise adagrad's (V,) accumulators shard
    over the model axis."""
    return [("['table'][", P("model"))] + param_rules


def data_parallel_mean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean over ``axes``' ranks of ``x``, this rank's mean over its
    equal block of the batch: the whole batch's mean, the same on every
    rank. Its cotangent is divided over the mesh as ``dlrm.loss``'s is
    (``out_boundary``), so that ``sync_grads`` over replicated params gives
    the reference's gradient."""
    part = psum(x, mesh, axes) / mesh.axis_size(axes)
    return out_boundary(part, mesh, P())


def train_fns(opt, loss_fn, mesh, p_specs, sum_axes=None):
    """A train cell's ``(loss_and_grads, train_step)`` for ``loss_fn(params,
    batch)``, the whole batch's loss on every rank: the gradient of every
    param block, summed over the mesh axes its spec ``p_specs`` leaves out
    (``sync_grads``; only over those of ``sum_axes`` where given), then the
    optimizer's update on the blocks."""

    def loss_and_grads(params, batch):
        leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
        loss = loss_fn(tree.unflatten(params, leaves), batch)
        grads = tree.unflatten(params, list(torch.autograd.grad(
            loss, leaves, materialize_grads=True)))
        if mesh is not None:
            grads = sync_grads(mesh, grads, p_specs, sum_axes)
        return loss.detach(), grads

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return loss_and_grads, train_step


def build_plan_generic(bundle, mesh, multi_pod, *, shape_name,
                       make_batch, loss_fn=None, fwd_fn=None,
                       batch_axes_map=None, microbatch: int | None = None,
                       param_rules_override=None, megatron: bool = False,
                       batch_layout=None, plain: bool = False) -> CellPlan:
    """Generic recsys/GNN cell builder (``repro/configs/recsys_common.py:
    44-122``).

    ``make_batch(dp)`` returns the batch dict of meta tensors;
    ``loss_fn(params, batch, mesh, axes)`` for train cells, ``fwd_fn`` for
    serve cells. ``batch_axes_map(batch, axes)`` optionally
    overrides the per-leaf batch specs. ``microbatch=n`` splits the train
    batch into ``n`` gradient-accumulation chunks: every per-sample leaf
    becomes (n, B/n, ...) with the batch sharding on the second dim, and
    the loss is the mean of the chunks' losses, each chunk's forward
    checkpointed (``torch.utils.checkpoint``), so that one chunk's
    activations are alive at a time in the backward. Side buffers like the
    DLRM's ``rank_of`` stay whole.

    Each rank holds its blocks of the params and the optimizer state under
    the specs (the row-wise accumulators beside their table's rows).
    ``megatron=True`` sums the gradients over the batch axes alone, for a
    ``loss_fn`` whose ``model`` ranks each hold the whole cotangent (DIN,
    BERT4Rec); else over every axis a spec leaves out.
    ``batch_layout(b_specs)`` gives the specs of the batch's blocks where
    ``fn`` takes other blocks than ``in_specs`` says (the 2D tables'
    ``rank_of``). ``plain=True`` is handed to ``loss_fn`` or ``fwd_fn``.
    """
    axes = bt_axes(multi_pod)
    dp = 32 if multi_pod else 16
    params = bundle.init(0, device="meta")
    batch = make_batch(dp)
    p_specs = make_param_specs(params,
                               param_rules_override or bundle.param_rules)
    if batch_axes_map is None:
        b_specs = tree.tree_map(
            lambda x: P(axes, *([None] * (x.ndim - 1))), batch)
    else:
        b_specs = batch_axes_map(batch, axes)
    route = {"plain": True} if plain else {}

    if loss_fn is None:
        def serve_step(params, batch):
            return fwd_fn(params, batch, mesh, axes, **route)

        return CellPlan(fn=serve_step, args=(params, batch),
                        in_specs=(p_specs, b_specs), out_specs=P(axes),
                        layout=None if batch_layout is None else
                        (p_specs, batch_layout(b_specs)))

    chunk_keys: tuple = ()
    if microbatch:
        # chunk only true per-sample leaves (leading dim == global batch)
        bsz = RECSYS_SHAPES[shape_name]["batch"]
        chunk_keys = tuple(k for k, v in batch.items()
                           if all(leaf.shape[:1] == (bsz,)
                                  for leaf in tree.leaves(v)))
        for k in chunk_keys:
            batch[k] = tree.tree_map(
                lambda x: torch.empty(
                    (microbatch, bsz // microbatch) + tuple(x.shape[1:]),
                    dtype=x.dtype, device="meta"), batch[k])
            b_specs[k] = tree.tree_map(
                lambda x: P(None, axes, *([None] * (x.ndim - 2))), batch[k])
    opt = bundle.optimizer
    opt_state = opt.init(params)
    o_specs = make_param_specs(opt_state, bundle.rules_for_opt())

    def full_loss(p, batch):
        if not microbatch:
            return loss_fn(p, batch, mesh, axes, **route)
        static = {k: v for k, v in batch.items() if k not in chunk_keys}
        acc = torch.zeros((), dtype=torch.float32,
                          device=tree.leaves(batch)[0].device)
        for i in range(microbatch):
            mb = {**static, **{k: tree.tree_map(lambda x, i=i: x[i],
                                                batch[k])
                               for k in chunk_keys}}
            acc = acc + checkpoint(lambda mb=mb: loss_fn(p, mb, mesh, axes,
                                                         **route),
                                   use_reentrant=False,
                                   preserve_rng_state=False)
        return acc / microbatch

    loss_and_grads, train_step = train_fns(opt, full_loss, mesh, p_specs,
                                           axes if megatron else None)
    return CellPlan(fn=train_step, args=(params, opt_state, batch),
                    in_specs=(p_specs, o_specs, b_specs),
                    out_specs=(p_specs, o_specs, P()), donate=(0, 1),
                    grads=loss_and_grads,
                    layout=None if batch_layout is None else
                    (p_specs, o_specs, batch_layout(b_specs)))


def per_sample_flops(flops_per_sample: float) -> dict[str, float]:
    """MODEL_FLOPS of each recsys cell: the forward's per-sample flops over
    its samples (candidates for retrieval), three times that to train."""
    return {s: flops_per_sample * RECSYS_SHAPES[s].get(
        "n_candidates", RECSYS_SHAPES[s]["batch"]) *
        (3.0 if s == "train_batch" else 1.0) for s in RECSYS_SHAPES}
