"""Import side-effect module: populates the arch registry (port of
``repro.configs.all_archs``).

Covers the LM family (qwen/nemotron/deepseek), GNN (graphsage), RecSys
(din/dlrm/bert4rec) and the paper's own benchmark models (rmc).
"""

import repro_torch.configs.bert4rec_arch     # noqa: F401
import repro_torch.configs.deepseek_v3_671b  # noqa: F401
import repro_torch.configs.din_arch          # noqa: F401
import repro_torch.configs.dlrm_mlperf       # noqa: F401
import repro_torch.configs.dlrm_rm2          # noqa: F401
import repro_torch.configs.graphsage_reddit  # noqa: F401
import repro_torch.configs.nemotron_4_15b    # noqa: F401
import repro_torch.configs.qwen2_0_5b        # noqa: F401
import repro_torch.configs.qwen3_1_7b        # noqa: F401
import repro_torch.configs.qwen3_moe_30b_a3b  # noqa: F401
import repro_torch.configs.rmc               # noqa: F401
