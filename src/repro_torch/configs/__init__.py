"""Model shapes and the arch registry (port of ``repro.configs``, and the
shapes the reference keeps beside its models).

The registry is its own modules, as the reference's is: ``base``
(``ArchBundle``, ``StepDef``, ``register``/``get_arch``/``list_archs``,
which import ``all_archs`` lazily), ``lm_common`` (the LM's sharding rules
and plans, ``LM_SHAPES``), ``recsys_common`` (``RECSYS_SHAPES``, the
partitioned optimizer, the generic recsys/GNN plan), and one module per
arch: ``qwen3_1_7b``, ``qwen2_0_5b``, ``nemotron_4_15b``,
``qwen3_moe_30b_a3b``, ``deepseek_v3_671b``, ``dlrm_mlperf``,
``dlrm_rm2``, ``rmc``, ``din_arch``, ``bert4rec_arch`` and
``graphsage_reddit``, each with its ``CONFIG`` and registered bundle.

This module re-exports their configs and rules under the names the port's
callers use (``DLRM_MLPERF``, ``DLRM_RM2``, ``PARAM_RULES``,
``OPT_RULES_2D``, ``RECSYS_SHAPES``, ``DIN``, ``BERT4REC``, ``CFG_*``,
``SAGE_SHAPES``, ``LM_ARCHS`` and the rest), each defined once in its arch
module; ``DLRMConfig``, ``make_rmc`` and RMC1-3 from ``models.dlrm``. It
holds ``small_dlrm`` and ``lm-100m`` (``repro.launch.train``).
``arch_shape`` is the arch resolution of ``repro.serving.deployment``;
``arch_model_config`` goes through the port's own ``DeploymentConfig``.
"""

from __future__ import annotations

from repro_torch.configs import (bert4rec_arch, deepseek_v3_671b, din_arch,
                                 dlrm_mlperf, dlrm_rm2, graphsage_reddit,
                                 nemotron_4_15b, qwen2_0_5b, qwen3_1_7b,
                                 qwen3_moe_30b_a3b)
from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    LONG_500K_SKIP, ArchBundle, StepDef, get_arch, list_archs, lm_shapes,
    register)
from repro_torch.configs.dlrm_mlperf import (  # noqa: F401  (re-exported)
    MLPERF_VOCABS, OPT_RULES_2D, PARAM_RULES, PARAM_RULES_2D, _pad512)
from repro_torch.configs.dlrm_mlperf import (  # noqa: F401  (re-exported)
    make_config as make_dlrm_config)
from repro_torch.configs.graphsage_reddit import (  # noqa: F401
    CFG_CORA, CFG_MOLECULE, CFG_PRODUCTS, CFG_REDDIT)
from repro_torch.configs.lm_common import (  # noqa: F401  (re-exported)
    LM_SHAPES, CellPlan, lm_active_params, lm_attn_params)
from repro_torch.configs.recsys_common import (  # noqa: F401  (re-exported)
    RECSYS_SHAPES, recsys_opt_rules)
from repro_torch.models.dlrm import (  # noqa: F401  (re-exported)
    RMC1, RMC2, RMC3, DLRMConfig, make_rmc)
from repro_torch.models.lm import LMConfig
from repro_torch.models.mla import MLAConfig  # noqa: F401  (re-exported)
from repro_torch.models.moe import MoEConfig  # noqa: F401  (re-exported)


def small_dlrm(n_rows=50_000):
    return DLRMConfig(
        name="dlrm-small", n_tables=8, n_dense=13, embed_dim=64,
        n_rows=(n_rows,) * 8, lookups=20, bot_mlp=(256, 128, 64),
        top_mlp=(256, 128))


# dlrm-mlperf: MLPerf DLRM (Criteo 1TB), vocabs padded to multiples of 512
DLRM_MLPERF = dlrm_mlperf.CONFIG
# dlrm-rm2: RM2-class DLRM, 26 x 1M x 64, 80 lookups per field
DLRM_RM2 = dlrm_rm2.CONFIG
# din: embed 18, seq 100, 1M items
DIN = din_arch.CONFIG
# bert4rec: the registry's config (ML-20m's items padded to /16: 26,752)
# and its cloze positions per sample
BERT4REC = bert4rec_arch.CONFIG
BERT4REC_N_MASK = bert4rec_arch.N_MASK
# graphsage: the shapes (each with its dataset's config, CFG_*)
SAGE_SHAPES = graphsage_reddit.SHAPES


# --------------------------------------------------------------- LM archs --
# each arch's config is its module's (``repro_torch.configs.<arch>``)
QWEN3_1_7B = qwen3_1_7b.CONFIG
QWEN2_0_5B = qwen2_0_5b.CONFIG
NEMOTRON_4_15B = nemotron_4_15b.CONFIG
QWEN3_MOE_30B_A3B_MOE = qwen3_moe_30b_a3b.MOE
QWEN3_MOE_30B_A3B = qwen3_moe_30b_a3b.CONFIG
DEEPSEEK_V3_671B_MLA = deepseek_v3_671b.MLA
DEEPSEEK_V3_671B_MOE = deepseek_v3_671b.MOE
DEEPSEEK_V3_671B = deepseek_v3_671b.CONFIG

LM_ARCHS = {c.name: c for c in (QWEN3_1_7B, QWEN2_0_5B, NEMOTRON_4_15B,
                                QWEN3_MOE_30B_A3B, DEEPSEEK_V3_671B)}

# lm-100m: the LM that ``launch.train --model lm`` trains
LM_100M = LMConfig(name="lm-100m", n_layers=8, d_model=512, n_heads=8,
                   n_kv_heads=4, d_ff=2048, vocab=32_000, qk_norm=True,
                   tie_embeddings=True, remat=False, q_chunk=128,
                   kv_chunk=128)


def lm_n_active(name: str) -> float:
    """The parameter count LM arch ``name``'s config module reports (its
    ``n_params()`` or ``n_active()``, the registry's ``n_active``)."""
    return lm_active_params(LM_ARCHS[name])


def arch_shape(name: str) -> DLRMConfig:
    """Resolve an architecture name to its DLRMConfig shape source."""
    key = name.lower().replace("-", "_")
    shapes = {"rmc1": RMC1, "rmc2": RMC2, "rmc3": RMC3,
              "dlrm_rm2": DLRM_RM2, "dlrm_mlperf": DLRM_MLPERF}
    if key in ("dlrm_small", "small"):
        return small_dlrm()
    if key in shapes:
        return shapes[key]
    raise KeyError(
        f"unknown serving arch {name!r}; have rmc1/rmc2/rmc3, dlrm_small, "
        f"dlrm_rm2, dlrm_mlperf")


def arch_model_config(arch: str, n_tables: int | None = None,
                      n_rows: int | None = None,
                      lookups: int | None = None) -> DLRMConfig:
    """The serving model of ``arch``:
    ``arch_model_config(DeploymentConfig.from_arch(arch, ...))``.

    Heterogeneous vocabs (dlrm_mlperf) are made uniform at
    ``min(1M, max vocab)`` rows per table unless ``n_rows`` overrides it;
    ``n_tables``/``lookups`` override the arch shape.
    """
    from repro_torch.serving import deployment   # it imports this module
    return deployment.arch_model_config(deployment.DeploymentConfig.from_arch(
        arch, n_tables=n_tables, n_rows=n_rows, lookups=lookups))
