"""graphsage-reddit [arXiv:1706.02216; gnn]: 2 layers, d_hidden 128, mean
aggregator, sample sizes 25-10 (port of ``repro.configs.graphsage_reddit``).

Four shapes, three execution regimes:
  full_graph_sm  Cora-scale full batch (2,708 nodes / 10,556 edges / 1,433
                 feats): graph too small to shard; a replicated cell.
  minibatch_lg   Reddit-scale sampled training: each data shard samples its
                 own block (1,024 global seeds / dp), fanout 15-10, padded
                 fixed shapes; the leading dim is the shard axis.
  ogb_products   full-batch large (2,449,029 nodes / 61,859,140 edges,
                 padded to /512 for even edge sharding, d_feat 100).
  molecule       128 graphs x 30 nodes x 64 edges, graph classification,
                 batch-sharded batched segment sums.

The SAGE weights are replicated (as in the reference). Under a mesh each
rank runs its block of the batch; the edge-sharded full graph sums its
segment sums over the batch axes (``graphsage.forward_full``), and each
loss is the whole batch's, so that ``sync_grads`` over the replicated
weights gives the reference's gradient. The reference's ``jax.vmap`` over
the shard axis of ``minibatch_lg`` is a loop over this rank's blocks.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import optim, tree
from repro_torch.configs.base import ArchBundle, StepDef, register
from repro_torch.configs.lm_common import CellPlan, _meta, bt_axes
from repro_torch.configs.recsys_common import (data_parallel_mean,
                                               train_fns)
from repro_torch.distributed.mesh import out_boundary
from repro_torch.distributed.shardings import P, make_param_specs
from repro_torch.models import graphsage

# per-shape model configs (d_in/classes follow the dataset of each shape)
CFG_REDDIT = graphsage.SAGEConfig(d_in=602, n_classes=41, fanouts=(15, 10))
CFG_CORA = graphsage.SAGEConfig(d_in=1433, n_classes=7)
CFG_PRODUCTS = graphsage.SAGEConfig(d_in=100, n_classes=47)
CFG_MOLECULE = graphsage.SAGEConfig(d_in=16, n_classes=2)

CONFIG = CFG_REDDIT
PARAM_RULES: list = []      # 128-wide SAGE weights are tiny -> replicate

SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(n_nodes=232_965, n_edges=114_615_892,
                         batch_nodes=1024, fanouts=(15, 10)),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_860_352,  # pad /512
                         d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128),
}


def _train_plan(bundle, mesh, cfg, batch, b_specs, loss_fn) -> CellPlan:
    """A train cell of ``loss_fn(params, batch)`` (the whole batch's loss
    on every rank) with the bundle's optimizer, the weights replicated."""
    params = graphsage.init(0, cfg, device="meta")
    p_specs = make_param_specs(params, bundle.param_rules)
    opt = bundle.optimizer
    opt_state = opt.init(params)
    o_specs = make_param_specs(opt_state, bundle.param_rules)
    loss_and_grads, train_step = train_fns(opt, loss_fn, mesh, p_specs)
    return CellPlan(train_step, (params, opt_state, batch),
                    (p_specs, o_specs, b_specs),
                    (p_specs, o_specs, P()), donate=(0, 1),
                    grads=loss_and_grads)


def _plan_full(bundle, mesh, multi_pod, *, cfg, shp, shard_edges):
    axes = bt_axes(multi_pod)
    n, e = shp["n_nodes"], shp["n_edges"]
    batch = {"feats": _meta((n, cfg.d_in), torch.float32),
             "edge_src": _meta((e,), torch.int32),
             "edge_dst": _meta((e,), torch.int32),
             "labels": _meta((n,), torch.int32),
             "train_mask": _meta((n,), torch.float32)}
    espec = P(axes) if shard_edges else P()
    b_specs = {"feats": P(), "edge_src": espec, "edge_dst": espec,
               "labels": P(), "train_mask": P()}

    def loss_fn(p, batch):
        loss = graphsage.loss_node(p, batch, cfg, mode="full",
                                   mesh=mesh if shard_edges else None,
                                   axes=axes)
        # the same on every rank: its cotangent divided over them
        return loss if mesh is None else out_boundary(loss, mesh, P())

    return _train_plan(bundle, mesh, cfg, batch, b_specs, loss_fn)


def _plan_minibatch(bundle, mesh, multi_pod, *, cfg):
    axes = bt_axes(multi_pod)
    dp = 32 if multi_pod else 16
    seeds = SHAPES["minibatch_lg"]["batch_nodes"] // dp   # per shard
    f1, f0 = cfg.fanouts[1], cfg.fanouts[0]               # 10 near seeds, 15
    n1 = seeds * (f1 + 1)
    n0 = n1 * (f0 + 1)
    batch = {
        "feats": _meta((dp, n0, cfg.d_in), torch.float32),
        "nbrs": [_meta((dp, n1, f0), torch.int32),
                 _meta((dp, seeds, f1), torch.int32)],
        "self_idx": [_meta((dp, n1), torch.int32),
                     _meta((dp, seeds), torch.int32)],
        "mask": [_meta((dp, n1, f0), torch.bool),
                 _meta((dp, seeds, f1), torch.bool)],
        "labels": _meta((dp, seeds), torch.int32),
    }
    b_specs = tree.tree_map(
        lambda x: P(axes, *([None] * (x.ndim - 1))), batch)

    def loss_fn(p, batch):
        # the reference vmaps the shard axis; this rank's blocks in turn
        n_blk = batch["labels"].shape[0]
        losses = torch.stack([graphsage.loss_node(
            p, tree.tree_map(lambda x, i=i: x[i], batch), cfg,
            mode="sampled") for i in range(n_blk)])
        loss = losses.mean()
        return loss if mesh is None else data_parallel_mean(loss, mesh, axes)

    return _train_plan(bundle, mesh, cfg, batch, b_specs, loss_fn)


def _plan_molecule(bundle, mesh, multi_pod, *, cfg):
    axes = bt_axes(multi_pod)
    shp = SHAPES["molecule"]
    b, n, e = shp["batch"], shp["n_nodes"], shp["n_edges"]
    batch = {"x": _meta((b, n, cfg.d_in), torch.float32),
             "edges": _meta((b, e, 2), torch.int32),
             "edge_mask": _meta((b, e), torch.bool),
             "node_mask": _meta((b, n), torch.bool),
             "labels": _meta((b,), torch.int32)}
    b_specs = tree.tree_map(
        lambda x: P(axes, *([None] * (x.ndim - 1))), batch)

    def loss_fn(p, batch):
        logits = graphsage.forward_batched_graphs(
            p, batch["x"], batch["edges"], batch["edge_mask"],
            batch["node_mask"], cfg)
        logp = torch.log_softmax(logits.float(), -1)
        loss = -torch.take_along_dim(
            logp, batch["labels"][:, None].long(), -1).mean()
        return loss if mesh is None else data_parallel_mean(loss, mesh, axes)

    return _train_plan(bundle, mesh, cfg, batch, b_specs, loss_fn)


def _sage_flops(cfg, n_nodes, n_edges) -> float:
    f = 2 * n_edges * cfg.d_in                     # layer-1 aggregate
    f += 2 * n_nodes * cfg.d_in * cfg.d_hidden * 2
    f += 2 * n_edges * cfg.d_hidden                # layer-2 aggregate
    f += 2 * n_nodes * cfg.d_hidden * cfg.d_hidden * 2
    f += 2 * n_nodes * cfg.d_hidden * cfg.n_classes
    return 3.0 * f                                 # fwd+bwd


@register("graphsage-reddit")
def build():
    bundle = ArchBundle(
        name="graphsage-reddit", family="gnn", cfg=CONFIG,
        init=functools.partial(graphsage.init, cfg=CFG_REDDIT),
        steps={}, param_rules=PARAM_RULES,
        optimizer=optim.adamw(1e-3),
        notes="segment_sum message passing; padded-fanout sampled blocks; "
              "per-shape dataset configs (Cora/Reddit/products/molecule)")
    bundle.steps = {
        "full_graph_sm": StepDef("train", functools.partial(
            _plan_full, cfg=CFG_CORA, shp=SHAPES["full_graph_sm"],
            shard_edges=False), None),
        "minibatch_lg": StepDef("train", functools.partial(
            _plan_minibatch, cfg=CFG_REDDIT), None),
        "ogb_products": StepDef("train", functools.partial(
            _plan_full, cfg=CFG_PRODUCTS, shp=SHAPES["ogb_products"],
            shard_edges=True), None),
        "molecule": StepDef("train", functools.partial(
            _plan_molecule, cfg=CFG_MOLECULE), None),
    }
    mb = SHAPES["minibatch_lg"]
    n1 = mb["batch_nodes"] * 11
    n0 = n1 * 16
    bundle.model_flops = {
        "full_graph_sm": _sage_flops(CFG_CORA, 2708, 10556),
        "minibatch_lg": _sage_flops(CFG_REDDIT, n0, n0 * 15),
        "ogb_products": _sage_flops(CFG_PRODUCTS, 2_449_029, 61_860_352),
        "molecule": _sage_flops(CFG_MOLECULE, 128 * 30, 128 * 64),
    }
    return bundle
