"""Shared plumbing for the five LM architectures (port of
``repro.configs.lm_common``).

Builds ArchBundles whose cells cover train_4k (a train step with the
optimizer's update), prefill_32k (prompt processing and the KV cache) and
decode_32k (one serve step over a 32k KV cache, the cache donated);
``long_500k`` is skipped for all five (pure full attention, DESIGN.md §4).

The sharding rules and specs are the reference's, as data: Megatron TP over
``model``, DP over ``pod`` x ``data``, KV caches split on the sequence over
``model``, MoE experts over ``model``, FSDP over ``data`` opt-in per arch.
A plan's ``fn`` takes on each rank exactly its block of every argument
under the plan's ``in_specs`` and returns its block of every output under
``out_specs`` (``models.lm``'s layout): ``layout`` is None for every LM
cell, so ``local_specs()`` is ``in_specs``. A plan's ``args`` are tensors
on the ``meta`` device: a full-size model's shapes, nothing allocated. Its
``fn`` closes over the mesh (or None, the local path), the params' specs
and the config the plan set; callers run it on the blocks of real tensors
of any batch the mesh divides.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch import tree
from repro_torch.configs.base import LONG_500K_SKIP, ArchBundle, StepDef
from repro_torch.distributed.shardings import (P, make_param_specs,
                                               sync_grads)
from repro_torch.models import lm


@dataclasses.dataclass
class CellPlan:
    """One cell's plan (``repro/configs/lm_common.py:31-37``): its ``fn``,
    the ``args`` it takes (meta tensors), their specs and the output's,
    the donated argnums."""

    fn: Any
    args: tuple
    in_specs: tuple
    out_specs: Any
    donate: tuple = ()
    # the train plan's (params, batch) -> (loss, gradients summed over the
    # batch axes): its fn's step before the optimizer's update
    grads: Any = None
    # the specs of the arguments as ``fn`` takes them on a rank, where they
    # differ from ``in_specs``: dlrm-mlperf's 2D train cell takes each
    # ``rank_of`` cut as its table's rows are (``recsys_common``'s
    # ``batch_layout``); None is ``in_specs``, as for every other cell
    layout: Any = None

    def local_specs(self):
        """The specs that cut each argument to the block ``fn`` takes on a
        rank."""
        return self.in_specs if self.layout is None else self.layout


def bt_axes(multi_pod: bool):
    """The batch axes (``repro/configs/lm_common.py:40-41``)."""
    return ("pod", "data") if multi_pod else ("data",)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------- LM shapes --
LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256),
    "prefill_32k": dict(seq=32768, batch=32),
    "decode_32k": dict(seq=32768, batch=128),
}


def lm_attn_params(c: lm.LMConfig) -> int:
    """Weights of one attention block (GQA or MLA), norms and biases
    aside."""
    if c.mla is None:
        return (c.d_model * c.head_dim * (c.n_heads + 2 * c.n_kv_heads)
                + c.n_heads * c.head_dim * c.d_model)
    a = c.mla
    return (c.d_model * a.q_lora_rank
            + a.q_lora_rank * c.n_heads * a.qk_head_dim
            + c.d_model * a.kv_lora_rank + c.d_model * a.rope_head_dim
            + a.kv_lora_rank * c.n_heads * (a.nope_head_dim + a.v_head_dim)
            + c.n_heads * a.v_head_dim * c.d_model)


def lm_active_params(c: lm.LMConfig) -> float:
    """The parameter count an LM arch's config module reports, by the
    module's own formula: the ``n_params()`` or ``n_active()`` of
    ``repro/configs/{qwen3_1_7b,qwen2_0_5b,nemotron_4_15b}.py`` (dense) and
    ``repro/configs/{qwen3_moe_30b_a3b,deepseek_v3_671b}.py`` (MoE), the
    registry's ``n_active``."""
    if c.moe is None:
        ffn = (3 if c.act == "swiglu" else 2) * c.d_model * c.d_ff
        embed = (1 if c.tie_embeddings else 2) * c.vocab * c.d_model
        return embed + c.n_layers * (lm_attn_params(c) + ffn)
    m = c.moe
    expert = 3 * c.d_model * m.d_expert
    if c.mla is None:
        per_layer = lm_attn_params(c) + m.top_k * expert \
            + c.d_model * m.n_experts
        return c.vocab * c.d_model + c.n_layers * per_layer
    dense_l = lm_attn_params(c) + 3 * c.d_model * c.d_ff
    moe_l = lm_attn_params(c) + (m.top_k + m.n_shared) * expert \
        + c.d_model * m.n_experts
    return (c.vocab * c.d_model * 2 + c.n_dense_layers * dense_l
            + (c.n_layers - c.n_dense_layers) * moe_l)


def lm_param_rules(cfg: lm.LMConfig, fsdp: bool = False,
                   data_axes=("data",)):
    """Path-substring -> PartitionSpec (stacked layers: leading L dim)
    (``repro/configs/lm_common.py:56-114``).

    ``fsdp`` shards the listed dims over ``data_axes`` — pass
    ("pod", "data") on the multi-pod mesh so a 671B model's param/grad
    state halves again across pods."""
    d = (data_axes if len(data_axes) > 1 else data_axes[0]) if fsdp else None
    rules = []
    if cfg.mtp:
        # MTP sub-block params are unstacked (2D) — match them first.
        rules += [
            ("['mtp']['proj']", P(d, "model")),
            ("['mtp']['norm']", P()),
            ("['mtp']['layer']['ln", P()),
            ("['mtp']['layer']['attn']['q_norm']", P()),
            ("['mtp']['layer']['attn']['kv_norm']", P()),
            ("['mtp']['layer']['attn']['w_o']", P("model", d)),
            ("['mtp']['layer']['attn']['w_kr']", P()),
            ("['mtp']['layer']['attn']", P(d, "model")),
            ("['mtp']['layer']['ffn']['w_down']", P("model", d)),
            ("['mtp']['layer']['ffn']['w_out']", P("model", d)),
            ("['mtp']['layer']['ffn']", P(d, "model")),
            ("['mtp']", P()),
        ]
    rules += [
        ("['embed']", P("model", d)),
        ("['head']", P(d, "model")),
        # attention (GQA)
        ("['wq']", P(None, d, "model")),
        ("['wk']", P(None, d, "model")),
        ("['wv']", P(None, d, "model")),
        ("['wo']", P(None, "model", d)),
        ("['bq']", P(None, "model")),
        ("['bk']", P(None, "model")),
        ("['bv']", P(None, "model")),
        # attention (MLA)
        ("['w_dq']", P(None, d, "model")),
        ("['w_uq']", P(None, d, "model")),
        ("['w_dkv']", P(None, d, "model")),
        ("['w_ukv']", P(None, d, "model")),
        ("['w_kr']", P(None, None, None)),
        ("['w_o']", P(None, "model", d)),
        # MoE experts: (L, E, D, F) — expert dim over model
        ("['moe']['w_gate']", P(None, "model", d, None)),
        ("['moe']['w_up']", P(None, "model", d, None)),
        ("['moe']['w_down']", P(None, "model", d, None)),
        ("['router']", P()),
        ("['shared']['w_gate']", P(None, d, "model")),
        ("['shared']['w_up']", P(None, d, "model")),
        ("['shared']['w_down']", P(None, "model", d)),
        # dense FFN: (L, D, F)
        ("['w_gate']", P(None, d, "model")),
        ("['w_up']", P(None, d, "model")),
        ("['w_down']", P(None, "model", d)),
        ("['w_in']", P(None, d, "model")),
        ("['w_out']", P(None, "model", d)),
    ]
    return rules


def serve_rules_2d(cfg: lm.LMConfig):
    """Deployment-time weight layout for MoE serving
    (``repro/configs/lm_common.py:272-283``): experts over model, expert-F
    over data, shared-expert F over (data x model); everything else
    Megatron-TP (non-FSDP) so decode never gathers weights."""
    return [
        ("['moe']['w_gate']", P(None, "model", None, "data")),
        ("['moe']['w_up']", P(None, "model", None, "data")),
        ("['moe']['w_down']", P(None, "model", "data", None)),
        ("['shared']['w_gate']", P(None, None, ("data", "model"))),
        ("['shared']['w_up']", P(None, None, ("data", "model"))),
        ("['shared']['w_down']", P(None, ("data", "model"), None)),
    ] + lm_param_rules(cfg, fsdp=False)


def _cache_specs(cfg: lm.LMConfig, axes):
    """The KV cache's specs (``repro/configs/lm_common.py:199-204``): batch
    over ``axes``, the sequence over ``model`` (flash-decoding's split-K,
    ``models.attention.decode_attention_split``)."""
    if cfg.mla is not None:
        return {"c": P(None, axes, "model", None),
                "kr": P(None, axes, "model", None)}
    return {"k": P(None, axes, "model", None, None),
            "v": P(None, axes, "model", None, None)}


def _params_meta(bundle: ArchBundle, dtype):
    return bundle.init(0, dtype=dtype, device="meta")


def _batch_specs(batch, axes):
    return tree.tree_map(lambda x: P(axes, *([None] * (x.ndim - 1))), batch)


def build_train_plan(bundle: ArchBundle, mesh, multi_pod: bool,
                     dtype=torch.bfloat16,
                     microbatch: int | None = None,
                     seq_shard: bool = False,
                     fsdp: bool = False) -> CellPlan:
    """Train cell (``repro/configs/lm_common.py:131-196``). ``microbatch=n``
    accumulates gradients over ``n`` sequential chunks of the batch's
    leading dim (each chunk's forward and backward in turn, so that one
    chunk's activations are alive at a time). ``seq_shard`` turns on
    sequence parallelism for the residual stream (``LMConfig.seq_shard``).

    ``fn(params, opt_state, batch) -> (params, opt_state, loss)``: forward,
    backward, the data-parallel sum of the gradients and the bundle
    optimizer's update; ``batch`` holds ``tokens`` and ``targets`` of
    (n, B/n, T) with ``microbatch``, else (B, T)."""
    cfg: lm.LMConfig = bundle.cfg
    shp = LM_SHAPES["train_4k"]
    axes = bt_axes(multi_pod)
    cfg = dataclasses.replace(cfg, batch_axes=axes, seq_shard=seq_shard)
    params = _params_meta(bundle, dtype)
    opt = bundle.optimizer
    opt_state = opt.init(params)
    if microbatch:
        # each accumulation chunk must still shard over every DP shard
        dp = 32 if multi_pod else 16
        microbatch = min(microbatch, shp["batch"] // dp)
    nmb = microbatch or 1
    lead = (nmb, shp["batch"] // nmb) if microbatch else (shp["batch"],)
    batch = {"tokens": _meta(lead + (shp["seq"],), torch.int32),
             "targets": _meta(lead + (shp["seq"],), torch.int32)}
    rules = bundle.param_rules
    if multi_pod and fsdp:
        rules = lm_param_rules(cfg, fsdp=True, data_axes=axes)
    p_specs = make_param_specs(params, rules)
    if opt.state_specs is not None:
        o_specs = opt.state_specs(params, p_specs)
    else:
        o_specs = make_param_specs(opt_state, bundle.rules_for_opt())
    if microbatch:
        b_specs = tree.tree_map(
            lambda x: P(None, axes, *([None] * (x.ndim - 2))), batch)
    else:
        b_specs = _batch_specs(batch, axes)

    specs = p_specs if mesh is not None else None
    update = opt.on_blocks(mesh, p_specs, o_specs)

    def loss_and_grads(params, batch):
        leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
        p = tree.unflatten(params, leaves)
        chunks = ([{k: v[i] for k, v in batch.items()} for i in range(nmb)]
                  if microbatch else [batch])
        loss, grads = None, None
        for mb in chunks:
            part = lm.train_loss(p, mb, cfg, mesh, specs) / len(chunks)
            g = torch.autograd.grad(part, leaves, materialize_grads=True)
            loss = part.detach() if loss is None else loss + part.detach()
            grads = list(g) if grads is None else [
                a + b for a, b in zip(grads, g, strict=True)]
        grads = tree.unflatten(params, grads)
        if mesh is not None:
            # the one sum left after lm's backward: over the batch axes a
            # spec leaves out (FSDP's and the 2D layout's backward of their
            # gathers summed over the axes they shard)
            grads = sync_grads(mesh, grads, p_specs, axes)
        return loss, grads

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        params, opt_state = update(grads, opt_state, params)
        return params, opt_state, loss

    return CellPlan(fn=train_step, args=(params, opt_state, batch),
                    in_specs=(p_specs, o_specs, b_specs),
                    out_specs=(p_specs, o_specs, P()),
                    donate=(0, 1), grads=loss_and_grads)


def build_decode_plan(bundle: ArchBundle, mesh, multi_pod: bool,
                      dtype=torch.bfloat16, ep_2d: bool = False,
                      serve_rules=None) -> CellPlan:
    """Decode cell (``repro/configs/lm_common.py:207-231``). ``ep_2d`` /
    ``serve_rules`` switch MoE archs to the weight-stationary serving
    layout: experts over model, expert-F over data, activations move
    instead of weights.

    ``fn(params, cache, tokens, length=32767)``: one decode step at
    ``length`` cached tokens (the reference's is static: the cache full
    but one slot), the cache updated in place."""
    cfg: lm.LMConfig = bundle.cfg
    shp = LM_SHAPES["decode_32k"]
    axes = bt_axes(multi_pod)
    cfg = dataclasses.replace(cfg, batch_axes=axes, ep_2d=ep_2d)
    params = _params_meta(bundle, dtype)
    cache = lm.init_cache(cfg, shp["batch"], shp["seq"], torch.bfloat16,
                          device="meta")
    tokens = _meta((shp["batch"],), torch.int32)
    p_specs = make_param_specs(params, serve_rules or bundle.param_rules)
    c_specs = _cache_specs(cfg, axes)
    full = shp["seq"] - 1     # static position: cache is full but one slot

    specs = p_specs if mesh is not None else None

    def serve_step(params, cache, tokens, length: int = full):
        return lm.decode_step(params, cache, tokens, length, cfg, mesh, specs)

    return CellPlan(fn=serve_step, args=(params, cache, tokens),
                    in_specs=(p_specs, c_specs, P(axes)),
                    out_specs=(P(axes, "model"), c_specs),
                    donate=(1,))


def build_prefill_plan(bundle: ArchBundle, mesh, multi_pod: bool,
                       dtype=torch.bfloat16, ep_2d: bool = False,
                       serve_rules=None,
                       ep_token_chunk: int | None = None) -> CellPlan:
    """Prefill cell (``repro/configs/lm_common.py:234-253``):
    ``fn(params, tokens) -> (last logits, cache)``."""
    cfg: lm.LMConfig = bundle.cfg
    shp = LM_SHAPES["prefill_32k"]
    axes = bt_axes(multi_pod)
    cfg = dataclasses.replace(cfg, batch_axes=axes, ep_2d=ep_2d,
                              ep_token_chunk=ep_token_chunk)
    params = _params_meta(bundle, dtype)
    tokens = _meta((shp["batch"], shp["seq"]), torch.int32)
    p_specs = make_param_specs(params, serve_rules or bundle.param_rules)
    c_specs = _cache_specs(cfg, axes)

    specs = p_specs if mesh is not None else None

    def prefill_step(params, tokens):
        return lm.prefill(params, tokens, cfg, mesh, specs)

    return CellPlan(fn=prefill_step, args=(params, tokens),
                    in_specs=(p_specs, P(axes, None)),
                    out_specs=(P(axes, "model"), c_specs))


def lm_model_flops(cfg: lm.LMConfig, n_active: float, shape: str) -> float:
    """MODEL_FLOPS: 6ND (+attention) train, 2ND (+attn) inference
    (``repro/configs/lm_common.py:256-269``)."""
    shp = LM_SHAPES[shape]
    tokens = shp["batch"] * shp["seq"]
    h_dh = cfg.n_heads * cfg.head_dim
    if shape == "train_4k":
        attn = 6 * cfg.n_layers * shp["seq"] * h_dh * tokens / 2
        return 6.0 * n_active * tokens + attn
    if shape == "prefill_32k":
        attn = 2 * cfg.n_layers * shp["seq"] * h_dh * tokens / 2
        return 2.0 * n_active * tokens + attn
    # decode: one token per sequence over the full cache
    attn = 2 * cfg.n_layers * shp["seq"] * h_dh * 2 * shp["batch"]
    return 2.0 * n_active * shp["batch"] + attn


def make_lm_bundle(name: str, cfg: lm.LMConfig, n_active: float,
                   optimizer, fsdp: bool = False,
                   train_microbatch: int | None = None,
                   serve_ep_2d: bool = False,
                   serve_param_rules=None,
                   prefill_ep_2d: bool = False,
                   prefill_token_chunk: int | None = None,
                   extra_notes: str = "") -> ArchBundle:
    """An LM arch's bundle (``repro/configs/lm_common.py:286-313``)."""
    bundle = ArchBundle(
        name=name, family="lm", cfg=cfg,
        init=functools.partial(lm.init, cfg=cfg),
        steps={}, param_rules=lm_param_rules(cfg, fsdp),
        optimizer=optimizer, notes=extra_notes)
    bundle.steps = {
        "train_4k": StepDef("train", functools.partial(
            build_train_plan, microbatch=train_microbatch, fsdp=fsdp), None),
        "prefill_32k": StepDef("prefill", functools.partial(
            build_prefill_plan, ep_2d=prefill_ep_2d,
            serve_rules=serve_param_rules if prefill_ep_2d else None,
            ep_token_chunk=prefill_token_chunk), None),
        "decode_32k": StepDef("decode", functools.partial(
            build_decode_plan, ep_2d=serve_ep_2d,
            serve_rules=serve_param_rules), None),
        "long_500k": StepDef("decode", None, None, skip=LONG_500K_SKIP),
    }
    bundle.model_flops = {s: lm_model_flops(cfg, n_active, s)
                          for s in LM_SHAPES}
    return bundle
