"""dlrm-mlperf [arXiv:1906.00091; recsys]: MLPerf DLRM (Criteo 1TB), 13
dense + 26 sparse fields, embed 128, bot 13-512-256-128, top
1024-1024-512-256-1, dot interaction, one-hot lookups (port of
``repro.configs.dlrm_mlperf``).

Vocab sizes are the MLPerf Criteo-1TB table sizes, rounded up to multiples
of 512 so each table row-shards evenly over the 16-way model axis. Remap
(the paper's RecFlash hash table) is on: ``rank_of`` buffers ride in the
batch (non-trainable) and, under a mesh, the two-phase sharded translation
feeds the SLS. Without a mesh a plan's call is the port's single-device
forward: one grouped SLS launch over every table with ``rank_of`` fused,
and one fused interaction launch (``models.dlrm``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchBundle, StepDef, register
from repro_torch.configs.lm_common import _meta
from repro_torch.configs.recsys_common import (RECSYS_SHAPES,
                                               build_plan_generic,
                                               per_sample_flops,
                                               recsys_opt_rules,
                                               recsys_optimizer)
from repro_torch.distributed.mesh import all_gather
from repro_torch.distributed.shardings import P
from repro_torch.models import dlrm
from repro_torch.tree import tree_map

MLPERF_VOCABS = [39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63,
                 38532951, 2953546, 403346, 10, 2208, 11938, 155, 4, 976,
                 14, 39979771, 25641295, 39664984, 585935, 12972, 108, 36]


def _pad512(v: int) -> int:
    return max(512, (v + 511) // 512 * 512)


def make_config(name="dlrm-mlperf", dim=128, bot=(13, 512, 256, 128),
                top=(1024, 1024, 512, 256, 1), vocabs=None, lookups=1):
    vocabs = vocabs or [_pad512(v) for v in MLPERF_VOCABS]
    return dlrm.DLRMConfig(
        name=name, n_tables=len(vocabs), n_dense=bot[0], embed_dim=dim,
        n_rows=tuple(vocabs), lookups=lookups,
        bot_mlp=tuple(bot[1:]), top_mlp=tuple(top[:-1]))


CONFIG = make_config()

PARAM_RULES = [("tables", P("model", None))]   # MLPs replicated (tiny)
# training's 2D layout: every row has one owner on the (model x data) grid
PARAM_RULES_2D = [("tables", P(("model", "data"), None))]
# with 2D tables the row-wise accumulators shard as their rows do
OPT_RULES_2D = [("['table'][", P(("model", "data")))] + PARAM_RULES_2D


def make_batch(cfg, shape_name, remap=True):
    """The cell's batch as meta tensors: ``rank_of`` a list of (V,) int32,
    one per table."""
    def fn(dp):
        shp = RECSYS_SHAPES[shape_name]
        b = shp["batch"]
        batch = {
            "dense": _meta((b, cfg.n_dense), torch.float32),
            "indices": _meta((b, cfg.n_tables, cfg.lookups), torch.int32),
        }
        if shape_name == "train_batch":
            batch["labels"] = _meta((b,), torch.float32)
        if shape_name == "retrieval_cand":
            batch["candidates"] = _meta((shp["n_candidates"],), torch.int32)
        if remap:
            batch["rank_of"] = [_meta((v,), torch.int32) for v in cfg.n_rows]
        return batch
    return fn


def batch_axes_map(cfg, shape_name):
    def fn(batch, axes):
        specs = tree_map(lambda x: P(axes, *([None] * (x.ndim - 1))), batch)
        if "rank_of" in batch:
            specs["rank_of"] = [P("model") for _ in batch["rank_of"]]
        if shape_name == "retrieval_cand":
            # the single user row cannot shard over data; candidates do.
            specs["dense"] = P(None, None)
            specs["indices"] = P(None, None, None)
            specs["candidates"] = P(axes)
        return specs
    return fn


def _rank_of_2d(b_specs):
    """The batch's blocks under the 2D tables: each ``rank_of`` cut as its
    table's rows are (the reference's ``shard_map`` in_spec of the 2D SLS,
    ``src/repro/models/dlrm.py:112-114``)."""
    if "rank_of" not in b_specs:
        return b_specs
    return {**b_specs, "rank_of": [P(("model", "data"))
                                   for _ in b_specs["rank_of"]]}


def _attach(p, batch, mesh):
    """The params with the batch's ``rank_of``: without a mesh through
    ``dlrm.add_remap``, which builds the grouped SLS's table descriptors
    (its hot size 1, as the reference's ``_bag`` reads the stored table
    whole). The dict is new on every call, so no graph captured for it
    would replay: it holds no ``GraphCache`` and the forward runs it on its
    eager route."""
    if "rank_of" not in batch:
        return p
    if mesh is None:
        return {**dlrm.add_remap(p, batch["rank_of"]), dlrm.GRAPHS: None}
    return {**p, "rank_of": batch["rank_of"]}


def loss_fn(cfg, hybrid=False, table_2d=False):
    def fn(p, batch, mesh, axes, plain=False):
        return dlrm.loss(_attach(p, batch, mesh), batch, cfg, mesh, axes,
                         hybrid=hybrid, table_2d=table_2d, plain=plain)
    return fn


def fwd_fn(cfg, retrieval=False, hybrid=False, table_2d=False):
    def fn(p, batch, mesh, axes, plain=False):
        if retrieval:
            # 1M candidates don't divide (data x model); hybrid stays off
            return dlrm.retrieval_score(_attach(p, batch, mesh), batch, cfg,
                                        mesh, axes, plain=plain)
        out = dlrm.forward(_attach(p, batch, mesh), batch, cfg, mesh, axes,
                           hybrid=hybrid, table_2d=table_2d, plain=plain)
        if mesh is not None and hybrid:
            # the hybrid layout leaves this rank the rows of its (axes x
            # model) block; the out_spec P(axes) holds its axes block
            out = all_gather(out, mesh, "model")
        return out
    return fn


def make_dlrm_bundle(name, cfg, remap=True, hybrid=False, table_2d=False):
    """``table_2d`` requires every vocab divisible by 256 (model x data)."""
    # mlperf-size tables (40M rows x 128) train in bf16 with f32 row-wise
    # adagrad accumulators, the industry-standard footprint
    dtype = torch.bfloat16 if max(cfg.n_rows) > 2_000_000 else torch.float32
    rules = PARAM_RULES_2D if table_2d else PARAM_RULES
    bundle = ArchBundle(
        name=name, family="recsys", cfg=cfg,
        init=functools.partial(dlrm.init, cfg=cfg, dtype=dtype),
        steps={}, param_rules=rules,
        opt_rules=OPT_RULES_2D if table_2d else recsys_opt_rules(rules),
        optimizer=recsys_optimizer(),
        notes="row-sharded tables, masked-psum SLS, RecFlash remap "
              + ("on" if remap else "off"))
    for s in RECSYS_SHAPES:
        kwargs = dict(shape_name=s, make_batch=make_batch(cfg, s, remap),
                      batch_axes_map=batch_axes_map(cfg, s))
        if s == "train_batch":
            # training layout: 2D row-sharded tables (no dense table-grad
            # all-reduce)
            kwargs["loss_fn"] = loss_fn(cfg, hybrid=hybrid,
                                        table_2d=table_2d)
            if table_2d and hybrid:
                kwargs["batch_layout"] = _rank_of_2d
        else:
            # serving layout: 1D (model-only) tables; the tables are
            # resharded at deployment
            kwargs["fwd_fn"] = fwd_fn(cfg, retrieval=(s == "retrieval_cand"),
                                      hybrid=hybrid, table_2d=False)
            if table_2d:
                kwargs["param_rules_override"] = PARAM_RULES
        bundle.steps[s] = StepDef(
            "train" if s == "train_batch" else "serve",
            functools.partial(build_plan_generic, **kwargs), None)
    bundle.model_flops = per_sample_flops(cfg.flops_per_sample())
    return bundle


@register("dlrm-mlperf")
def build():
    """Hybrid dense sharding and 2D row-sharded tables (vocabs padded to
    /512, so they divide the 256-way grid)."""
    return make_dlrm_bundle("dlrm-mlperf", CONFIG, hybrid=True,
                            table_2d=True)
