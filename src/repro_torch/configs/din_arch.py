"""din [arXiv:1706.06978; recsys]: embed 18, seq 100, attn MLP 80-40, MLP
200-80, target attention; a 1M-item table (port of
``repro.configs.din_arch``).

The item table is row-sharded over ``model`` as in the reference
(``PARAM_RULES``): under a mesh each rank holds its row block of ``items``
and of its row-wise adagrad accumulator, and ``models.din`` looks up every
id through a masked local lookup summed over ``model``; the MLPs are
replicated and each rank runs its block of the batch."""

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
from repro_torch.distributed.shardings import P
from repro_torch.models import din
from repro_torch.tree import tree_map

CONFIG = din.DINConfig(n_items=1_000_000)

PARAM_RULES = [("items", P("model", None))]


def make_batch(shape_name):
    def fn(dp):
        shp = RECSYS_SHAPES[shape_name]
        b = shp["batch"]
        batch = {
            "hist": _meta((b, CONFIG.seq_len), torch.int32),
            "hist_mask": _meta((b, CONFIG.seq_len), torch.bool),
            "profile": _meta((b, CONFIG.n_profile), torch.float32),
        }
        if shape_name == "train_batch":
            batch["target"] = _meta((b,), torch.int32)
            batch["labels"] = _meta((b,), torch.float32)
        elif shape_name == "retrieval_cand":
            batch["candidates"] = _meta((shp["n_candidates"],), torch.int32)
        else:
            batch["target"] = _meta((b,), torch.int32)
        return batch
    return fn


def batch_axes_map(shape_name):
    def fn(batch, axes):
        specs = tree_map(lambda x: P(axes, *([None] * (x.ndim - 1))), batch)
        if shape_name == "retrieval_cand":
            specs = tree_map(lambda s: P(*([None] * len(s))), specs)
            specs["candidates"] = P(axes)
        return specs
    return fn


def _loss(p, batch, mesh, axes):
    return din.loss(p, batch, CONFIG, mesh, axes)


def _fwd(p, batch, mesh, axes):
    return din.forward(p, batch, CONFIG, mesh)


def _retr(p, batch, mesh, axes):
    return din.retrieval_score(p, batch, CONFIG, mesh)


@register("din")
def build():
    bundle = ArchBundle(
        name="din", family="recsys", cfg=CONFIG,
        init=functools.partial(din.init, cfg=CONFIG),
        steps={}, param_rules=PARAM_RULES,
        opt_rules=recsys_opt_rules(PARAM_RULES),
        optimizer=recsys_optimizer(),
        notes="item table row-sharded; target attention dense")
    for s in RECSYS_SHAPES:
        kwargs = dict(shape_name=s, make_batch=make_batch(s),
                      batch_axes_map=batch_axes_map(s), megatron=True)
        if s == "train_batch":
            kwargs["loss_fn"] = _loss
        elif s == "retrieval_cand":
            kwargs["fwd_fn"] = _retr
        else:
            kwargs["fwd_fn"] = _fwd
        bundle.steps[s] = StepDef(
            "train" if s == "train_batch" else "serve",
            functools.partial(build_plan_generic, **kwargs), None)
    bundle.model_flops = per_sample_flops(CONFIG.flops_per_sample())
    return bundle
