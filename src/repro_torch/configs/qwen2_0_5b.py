"""qwen2-0.5b [arXiv:2407.10671; dense] — 24L d896 14H (GQA kv=2)
d_ff 4864, vocab 151936, QKV bias, tied embeddings (port of
``repro.configs.qwen2_0_5b``)."""

from repro_torch import optim
from repro_torch.configs.base import register
from repro_torch.configs.lm_common import lm_active_params, make_lm_bundle
from repro_torch.distributed.shardings import P
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_head=64, d_ff=4864, vocab=151936, act="swiglu", qkv_bias=True,
    rope_theta=1_000_000.0, tie_embeddings=True,
    # 14 heads x 64 = 896: neither 14 nor 896/16 tiles a 16-way model
    # axis, so context-parallel attention shards the O(T^2) compute on the
    # sequence instead
    context_parallel=True)


@register("qwen2-0.5b")
def build():
    """The registered bundle (``repro/configs/qwen2_0_5b.py:28-42``)."""
    bundle = make_lm_bundle("qwen2-0.5b", CONFIG,
                            n_active=lm_active_params(CONFIG),
                            optimizer=optim.adamw(3e-4, weight_decay=0.1),
                            train_microbatch=2)
    # the attention projections (14 x 64 = 896 cols) do not divide the
    # model axis: replicate attention, shard the FFN and the vocab
    bundle.param_rules = [
        ("['wq']", P()), ("['wk']", P()), ("['wv']", P()), ("['wo']", P()),
        ("['bq']", P()), ("['bk']", P()), ("['bv']", P()),
    ] + bundle.param_rules
    return bundle
