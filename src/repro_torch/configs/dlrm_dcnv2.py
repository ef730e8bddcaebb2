"""dlrm-dcnv2: MLPerf's DLRM-DCNv2 on Criteo 1TB multi-hot, the
recommendation benchmark of MLPerf Training v3.0 and later and MLPerf
Inference ``dlrm-v2``: mlcommons/training ``recommendation_v2/
torchrec_dlrm`` (TorchRec's ``DLRM_DCN`` with its ``LowRankCrossNet``;
the cross network of Wang et al., arXiv:2008.13535).

26 tables of Criteo 1TB's vocabularies capped at 40M rows
(``--num_embeddings_per_feature``), 204,184,588 rows, embeddings of 128;
multi-hot bags of one length a table
(``--multi_hot_sizes``, 214 lookups a sample); bottom MLP 13-512-256-128;
a cross network of 3 low-rank layers of rank 512 over x0 = [bottom; 26
bags] (3,456 wide); top MLP 3456-1024-1024-512-256-1.

Not registered: the arch registry is the reference's (``configs.
list_archs`` is held equal to it), and the reference has no DCN. The port
runs it through ``models.dlrm``'s entry points (``init`` or the caller's
weights, ``add_remap``, ``forward``), as it runs rmc2 and dlrm-mlperf.
"""

from __future__ import annotations

from repro_torch.models.dlrm import DCNConfig

VOCABS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
          3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
          40000000, 40000000, 590152, 12973, 108, 36)
BAG_LENGTHS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
               100, 27, 10, 3, 1, 1)

CONFIG = DCNConfig(
    name="dlrm-dcnv2", n_tables=len(VOCABS), n_dense=13, embed_dim=128,
    n_rows=VOCABS, lookups=BAG_LENGTHS, bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256), interaction="dcn", dcn_layers=3,
    dcn_rank=512)
