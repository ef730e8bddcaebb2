"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B; moe] — 48L d2048 32H (GQA kv=4,
d_head 128), 128 experts top-8 (d_expert 768), vocab 151936, qk-norm (port
of ``repro.configs.qwen3_moe_30b_a3b``).

Expert parallelism over ``model`` (replicated-activation EP,
``models.moe.moe_ffn_sharded``), the 2D serving layout for decode;
optimizer states ZeRO-shard the layer dim over ``data``."""

from repro_torch import optim
from repro_torch.configs.base import register
from repro_torch.configs.lm_common import (lm_active_params, make_lm_bundle,
                                           serve_rules_2d)
from repro_torch.distributed.shardings import P
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoEConfig

MOE = MoEConfig(d_model=2048, d_expert=768, n_experts=128, top_k=8,
                capacity_factor=1.5, norm_topk=True)

CONFIG = LMConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, d_head=128, d_ff=768, vocab=151936, act="swiglu",
    qk_norm=True, rope_theta=1_000_000.0, moe=MOE, n_dense_layers=0,
    ep_axis="model")


@register("qwen3-moe-30b-a3b")
def build():
    """The registered bundle (``repro/configs/qwen3_moe_30b_a3b.py:35-51``)."""
    bundle = make_lm_bundle(
        "qwen3-moe-30b-a3b", CONFIG, n_active=lm_active_params(CONFIG),
        optimizer=optim.adamw(3e-4, weight_decay=0.1),
        fsdp=True, train_microbatch=8,
        serve_ep_2d=True, serve_param_rules=serve_rules_2d(CONFIG),
        extra_notes="EP over model axis + FSDP over data; AdamW moments "
                    "ZeRO-sharded over data on the stacked-layer dim; "
                    "8-way gradient accumulation")
    # ZeRO: moments of the expert tensors additionally shard L over data
    bundle.opt_rules = [
        ("['moe']['w_gate']", P("data", "model", None, None)),
        ("['moe']['w_up']", P("data", "model", None, None)),
        ("['moe']['w_down']", P("data", "model", None, None)),
    ] + bundle.param_rules
    return bundle
