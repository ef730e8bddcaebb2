"""DLRM shapes: the model config, the paper's RMC classes and the registry
archs the serving path takes (numpy and dataclasses only).

Copied from the reference: ``DLRMConfig``/``make_rmc``/RMC1-3
(``repro.models.dlrm``), ``small_dlrm`` (``repro.launch.train``), the
dlrm-mlperf and dlrm-rm2 shapes (``repro.configs``). ``arch_shape`` is
the arch resolution of ``repro.serving.deployment``; ``arch_model_config``
goes through the port's own ``DeploymentConfig``.
"""

from __future__ import annotations

import dataclasses


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
