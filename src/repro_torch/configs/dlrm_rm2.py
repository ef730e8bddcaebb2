"""dlrm-rm2 [arXiv:1906.00091; recsys]: RM2-class DLRM, 13 dense + 26
sparse fields, embed 64, bot 13-512-256-64, top 512-512-256-1, dot
interaction; 1M rows a table, multi-hot 80 lookups a field (RM2 is the
embedding-dominated, pooling-heavy class: the RecNMP/RecSSD convention).
Port of ``repro.configs.dlrm_rm2``."""

from repro_torch.configs.base import register
from repro_torch.configs.dlrm_mlperf import make_config, make_dlrm_bundle

CONFIG = make_config(
    name="dlrm-rm2", dim=64, bot=(13, 512, 256, 64),
    top=(512, 512, 256, 1), vocabs=[1_000_000] * 26, lookups=80)


@register("dlrm-rm2")
def build():
    return make_dlrm_bundle("dlrm-rm2", CONFIG)
