"""deepseek-v3-671b [arXiv:2412.19437; moe] — 61L d7168 128H MLA,
1 shared + 256 routed experts top-8 (d_expert 2048), first 3 layers dense
(d_ff 18432), vocab 129280, MTP head (port of
``repro.configs.deepseek_v3_671b``).

FSDP over ``data`` (params and gradients), Adafactor's factored statistics
(AdamW's moments of 671B params cannot fit), expert parallelism over
``model``, the 2D serving layout for decode and for prefill in chunks of
2048 tokens."""

from repro_torch import optim
from repro_torch.configs.base import register
from repro_torch.configs.lm_common import (lm_active_params, make_lm_bundle,
                                           serve_rules_2d)
from repro_torch.models.lm import LMConfig
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig

MLA = MLAConfig(d_model=7168, n_heads=128, q_lora_rank=1536,
                kv_lora_rank=512, nope_head_dim=128, rope_head_dim=64,
                v_head_dim=128, rope_theta=10_000.0)

MOE = MoEConfig(d_model=7168, d_expert=2048, n_experts=256, top_k=8,
                n_shared=1, capacity_factor=1.25, norm_topk=True,
                router_bias=True)   # aux-loss-free bias routing

CONFIG = LMConfig(
    name="deepseek-v3-671b", n_layers=61, d_model=7168, n_heads=128,
    n_kv_heads=128, d_ff=18432, vocab=129280, act="swiglu",
    rope_theta=10_000.0, moe=MOE, n_dense_layers=3, mla=MLA, mtp=True,
    ep_axis="model")


@register("deepseek-v3-671b")
def build():
    """The registered bundle (``repro/configs/deepseek_v3_671b.py:47-57``)."""
    return make_lm_bundle(
        "deepseek-v3-671b", CONFIG, n_active=lm_active_params(CONFIG),
        optimizer=optim.adafactor(1e-4),
        fsdp=True, train_microbatch=4,
        serve_ep_2d=True, serve_param_rules=serve_rules_2d(CONFIG),
        prefill_ep_2d=True, prefill_token_chunk=2048,
        extra_notes="FSDP over data axis (params+grads), Adafactor factored "
                    "stats, MLA latent KV cache, MTP aux head, EP over model, "
                    "8-way gradient accumulation")
