"""qwen3-1.7b [hf:Qwen/Qwen3-8B family; dense] — 28L d2048 16H (GQA kv=8)
d_ff 6144, vocab 151936, qk-norm, tied embeddings (port of
``repro.configs.qwen3_1_7b``)."""

from repro_torch import optim
from repro_torch.configs.base import register
from repro_torch.configs.lm_common import lm_active_params, make_lm_bundle
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_head=128, d_ff=6144, vocab=151936, act="swiglu", qk_norm=True,
    rope_theta=1_000_000.0, tie_embeddings=True)


@register("qwen3-1.7b")
def build():
    """The registered bundle (``repro/configs/qwen3_1_7b.py:23-27``)."""
    return make_lm_bundle("qwen3-1.7b", CONFIG,
                          n_active=lm_active_params(CONFIG),
                          optimizer=optim.adamw(3e-4, weight_decay=0.1),
                          train_microbatch=4)
