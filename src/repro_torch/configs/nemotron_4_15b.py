"""nemotron-4-15b [arXiv:2402.16819; dense] — 32L d6144 48H (GQA kv=8)
d_ff 24576, vocab 256000, squared-ReLU (non-gated) FFN, untied head (port
of ``repro.configs.nemotron_4_15b``)."""

from repro_torch import optim
from repro_torch.configs.base import register
from repro_torch.configs.lm_common import lm_active_params, make_lm_bundle
from repro_torch.distributed.shardings import P
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-15b", n_layers=32, d_model=6144, n_heads=48,
    n_kv_heads=8, d_head=128, d_ff=24576, vocab=256000, act="squared_relu",
    rope_theta=10_000.0, tie_embeddings=False)


@register("nemotron-4-15b")
def build():
    """The registered bundle (``repro/configs/nemotron_4_15b.py:23-45``)."""
    bundle = make_lm_bundle("nemotron-4-15b", CONFIG,
                            n_active=lm_active_params(CONFIG),
                            optimizer=optim.adamw(3e-4, weight_decay=0.1),
                            train_microbatch=16,
                            extra_notes="AdamW moments ZeRO-sharded over "
                                        "data (stacked-layer / vocab dims)")
    # ZeRO: the AdamW moments shard the stacked-L (or vocab) dim over data
    bundle.opt_rules = [
        ("['embed']", P("model", "data")),
        ("['head']", P("data", "model")),
        ("['wq']", P("data", None, "model")),
        ("['wk']", P("data", None, "model")),
        ("['wv']", P("data", None, "model")),
        ("['wo']", P("data", "model", None)),
        ("['w_in']", P("data", None, "model")),
        ("['w_out']", P("data", "model", None)),
    ] + bundle.param_rules
    return bundle
