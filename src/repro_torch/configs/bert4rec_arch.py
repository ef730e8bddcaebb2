"""bert4rec [arXiv:1904.06690; recsys]: embed 64, 2 blocks, 2 heads, seq
200, bidirectional self-attention, cloze training (20 masked positions per
sample). Encoder-only: serve cells run full-sequence scoring (its real
serving mode); there is no autoregressive decode (DESIGN.md §4). Port of
``repro.configs.bert4rec_arch``.

The item table is row-sharded over ``model`` as in the reference
(``PARAM_RULES``): under a mesh each rank holds its row block of ``items``
and of its row-wise adagrad accumulator, looks ids up through a masked
local lookup summed over ``model``, and runs the tied output on its vocab
block (``models.bert4rec``); the encoder is replicated and each rank runs
its block of the batch. The cloze loss is the whole batch's, a ratio of
sums over the batch axes."""

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
from repro_torch.models import bert4rec
from repro_torch.tree import tree_map

N_MASK = 20

CONFIG = bert4rec.Bert4RecConfig(n_items=26_752)   # ML-20m, padded /16

PARAM_RULES = [("items", P("model", None))]


def make_batch(shape_name):
    def fn(dp):
        shp = RECSYS_SHAPES[shape_name]
        b = shp["batch"]
        t = CONFIG.seq_len
        batch = {
            "items": _meta((b, t), torch.int32),
            "pad_mask": _meta((b, t), torch.bool),
        }
        if shape_name == "train_batch":
            batch.update({
                "mask_pos": _meta((b, N_MASK), torch.int32),
                "targets": _meta((b, N_MASK), torch.int32),
                "target_mask": _meta((b, N_MASK), torch.bool),
            })
        if shape_name == "retrieval_cand":
            batch["candidates"] = _meta((shp["n_candidates"],), torch.int32)
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
    return bert4rec.loss(p, batch, CONFIG, mesh, axes)


def _score(p, batch, mesh, axes):
    # serving: next-item logits of the last position, (B, n_items)
    return bert4rec.score(p, batch, CONFIG, mesh)


def _retr(p, batch, mesh, axes):
    return bert4rec.retrieval_score(p, batch, CONFIG, mesh)


@register("bert4rec")
def build():
    bundle = ArchBundle(
        name="bert4rec", family="recsys", cfg=CONFIG,
        init=functools.partial(bert4rec.init, cfg=CONFIG),
        steps={}, param_rules=PARAM_RULES,
        opt_rules=recsys_opt_rules(PARAM_RULES),
        optimizer=recsys_optimizer(),
        notes="encoder-only; serve = full-sequence scoring; "
              "item table row-sharded over model")
    for s in RECSYS_SHAPES:
        kwargs = dict(shape_name=s, make_batch=make_batch(s),
                      batch_axes_map=batch_axes_map(s), megatron=True)
        if s == "train_batch":
            kwargs["loss_fn"] = _loss
            # 16 grad-accumulation chunks: a fused 65k step's (B, 20, 26752)
            # f32 cloze logits alone are ~9 GB per device otherwise.
            kwargs["microbatch"] = 16
        elif s == "retrieval_cand":
            kwargs["fwd_fn"] = _retr
        else:
            kwargs["fwd_fn"] = _score
        bundle.steps[s] = StepDef(
            "train" if s == "train_batch" else "serve",
            functools.partial(build_plan_generic, **kwargs), None)
    bundle.model_flops = per_sample_flops(CONFIG.flops_per_sample())
    return bundle
