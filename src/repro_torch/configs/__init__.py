"""Model shapes and the arch registry (port of ``repro.configs``, and the
shapes the reference keeps beside its models).

The LM half of the registry is its own modules: ``base`` (``ArchBundle``,
``StepDef``, ``register``/``get_arch``/``list_archs``), ``lm_common`` (the
sharding rules, the train/prefill/decode plans, ``LM_SHAPES``) and one
module per LM arch (``qwen3_1_7b``, ``qwen2_0_5b``, ``nemotron_4_15b``,
``qwen3_moe_30b_a3b``, ``deepseek_v3_671b``), each with its ``CONFIG``
(and ``MOE``/``MLA``) and registered bundle; this module names their
configs (``QWEN3_1_7B`` and the rest, ``LM_ARCHS``) and parameter counts.

This module holds the rest, copied from the reference as constants (their
bundles are not ported yet, ROADMAP A14): ``DLRMConfig``/``make_rmc``/
RMC1-3 (``repro.models.dlrm``), ``small_dlrm`` and ``lm-100m``
(``repro.launch.train``), the dlrm-mlperf and dlrm-rm2 shapes and sharding
rules (``repro.configs``), the recsys cell shapes (``repro.configs.
recsys_common.RECSYS_SHAPES``) and the DIN, BERT4Rec and GraphSAGE configs
of ``repro.configs.{din_arch,bert4rec_arch,graphsage_reddit}``.
``arch_shape`` is the arch resolution of ``repro.serving.deployment``;
``arch_model_config`` goes through the port's own ``DeploymentConfig``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_v3_671b, nemotron_4_15b,
                                 qwen2_0_5b, qwen3_1_7b, qwen3_moe_30b_a3b)
from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    LONG_500K_SKIP, ArchBundle, StepDef, get_arch, list_archs, lm_shapes,
    register)
from repro_torch.configs.lm_common import (  # noqa: F401  (re-exported)
    LM_SHAPES, CellPlan, lm_active_params, lm_attn_params)
from repro_torch.distributed.shardings import P
from repro_torch.models.bert4rec import Bert4RecConfig
from repro_torch.models.din import DINConfig
from repro_torch.models.graphsage import SAGEConfig
from repro_torch.models.lm import LMConfig
from repro_torch.models.mla import MLAConfig  # noqa: F401  (re-exported)
from repro_torch.models.moe import MoEConfig  # noqa: F401  (re-exported)


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_tables: int
    n_dense: int
    embed_dim: int
    n_rows: tuple           # per-table vocab sizes (len == n_tables)
    lookups: int            # multi-hot width per table
    bot_mlp: tuple          # hidden sizes; input = n_dense, output = embed_dim
    top_mlp: tuple          # hidden sizes; output = 1
    interaction: str = "dot"

    @property
    def n_vectors(self) -> int:
        return self.n_tables + 1

    @property
    def top_in(self) -> int:
        if self.interaction == "dot":
            n = self.n_vectors
            return self.embed_dim + n * (n - 1) // 2
        return self.n_vectors * self.embed_dim    # concat interaction

    def flops_per_sample(self) -> int:
        """MODEL_FLOPS estimate (fwd): 2*MACs of MLPs + interaction + SLS."""
        f = 0
        sizes = (self.n_dense,) + tuple(self.bot_mlp) + (self.embed_dim,)
        f += sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:], strict=True))
        tsizes = (self.top_in,) + tuple(self.top_mlp) + (1,)
        f += sum(2 * a * b for a, b in zip(tsizes[:-1], tsizes[1:], strict=True))
        f += 2 * self.n_vectors * self.n_vectors * self.embed_dim  # pairwise dot
        f += 2 * self.n_tables * self.lookups * self.embed_dim     # SLS adds
        return f


def make_rmc(name: str, n_tables: int, dim: int, lookups: int,
             bot: tuple, top: tuple, n_rows: int = 1_000_000,
             n_dense: int | None = None) -> DLRMConfig:
    """Table-II helper: sizes listed as `in-h1-..` for bottom, `h..-1` top."""
    return DLRMConfig(name=name, n_tables=n_tables,
                      n_dense=n_dense if n_dense is not None else bot[0],
                      embed_dim=dim, n_rows=(n_rows,) * n_tables,
                      lookups=lookups, bot_mlp=tuple(bot[1:-1]) + (bot[-1],),
                      top_mlp=tuple(top[:-1]))


# Table II (paper) — bottom lists include input dim, tops end with 1.
RMC1 = make_rmc("rmc1", 8, 32, 80, (128, 64, 32), (256, 64, 1))
RMC2 = make_rmc("rmc2", 32, 64, 120, (256, 128, 64), (128, 64, 1))
RMC3 = make_rmc("rmc3", 10, 32, 20, (2560, 1024, 256, 32), (512, 256, 1))


def small_dlrm(n_rows=50_000):
    return DLRMConfig(
        name="dlrm-small", n_tables=8, n_dense=13, embed_dim=64,
        n_rows=(n_rows,) * 8, lookups=20, bot_mlp=(256, 128, 64),
        top_mlp=(256, 128))


MLPERF_VOCABS = [39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63,
                 38532951, 2953546, 403346, 10, 2208, 11938, 155, 4, 976,
                 14, 39979771, 25641295, 39664984, 585935, 12972, 108, 36]


def _pad512(v: int) -> int:
    return max(512, (v + 511) // 512 * 512)


def make_dlrm_config(name="dlrm-mlperf", dim=128, bot=(13, 512, 256, 128),
                     top=(1024, 1024, 512, 256, 1), vocabs=None, lookups=1):
    vocabs = vocabs or [_pad512(v) for v in MLPERF_VOCABS]
    return DLRMConfig(
        name=name, n_tables=len(vocabs), n_dense=bot[0], embed_dim=dim,
        n_rows=tuple(vocabs), lookups=lookups,
        bot_mlp=tuple(bot[1:]), top_mlp=tuple(top[:-1]))


# dlrm-mlperf: MLPerf DLRM (Criteo 1TB), vocabs padded to multiples of 512.
DLRM_MLPERF = make_dlrm_config()
# dlrm-rm2: RM2-class DLRM, 26 x 1M x 64, 80 lookups per field.
DLRM_RM2 = make_dlrm_config(
    name="dlrm-rm2", dim=64, bot=(13, 512, 256, 64),
    top=(512, 512, 256, 1), vocabs=[1_000_000] * 26, lookups=80)

# dlrm-mlperf's sharding rules (repro.configs.dlrm_mlperf): tables
# row-sharded over the model axis, MLPs replicated; or, for training, over
# (model x data), so every row has one owner (vocabs pad to /512, so they
# divide the 256-way grid).
PARAM_RULES = [("tables", P("model", None))]
PARAM_RULES_2D = [("tables", P(("model", "data"), None))]


def recsys_opt_rules(param_rules):
    """Optimizer-state rules (repro.configs.recsys_common): row-wise
    adagrad's (V,) accumulators shard over the model axis."""
    return [("['table'][", P("model"))] + param_rules


# with 2D tables the accumulators shard as their rows do
# (repro.configs.dlrm_mlperf.make_dlrm_bundle)
OPT_RULES_2D = [("['table'][", P(("model", "data")))] + PARAM_RULES_2D


# the recsys cells (repro.configs.recsys_common.RECSYS_SHAPES)
RECSYS_SHAPES = {
    "train_batch": dict(batch=65_536),
    "serve_p99": dict(batch=512),
    "serve_bulk": dict(batch=262_144),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000),
}

# din (repro.configs.din_arch.CONFIG): embed 18, seq 100, 1M items
DIN = DINConfig(n_items=1_000_000)
# bert4rec: the model's own default (ML-20m's 26,744 items), and the
# registry's cloze positions per sample (repro.configs.bert4rec_arch)
BERT4REC = Bert4RecConfig()
BERT4REC_N_MASK = 20

# graphsage (repro.configs.graphsage_reddit): per-shape model configs
# (d_in and classes follow each shape's dataset) and the shapes
CFG_REDDIT = SAGEConfig(d_in=602, n_classes=41, fanouts=(15, 10))
CFG_CORA = SAGEConfig(d_in=1433, n_classes=7)
CFG_PRODUCTS = SAGEConfig(d_in=100, n_classes=47)
CFG_MOLECULE = SAGEConfig(d_in=16, n_classes=2)
SAGE_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(n_nodes=232_965, n_edges=114_615_892,
                         batch_nodes=1024, fanouts=(15, 10)),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_860_352,  # pad /512
                         d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128),
}


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
