"""RMC1/RMC2/RMC3: the paper's own DLRM benchmark configs (Table II),
registered as archs with the full recsys cell set, RecFlash remap on (port
of ``repro.configs.rmc``)."""

from repro_torch.configs.base import register
from repro_torch.configs.dlrm_mlperf import make_dlrm_bundle
from repro_torch.models.dlrm import RMC1, RMC2, RMC3


@register("rmc1")
def build_rmc1():
    return make_dlrm_bundle("rmc1", RMC1)


@register("rmc2")
def build_rmc2():
    return make_dlrm_bundle("rmc2", RMC2)


@register("rmc3")
def build_rmc3():
    return make_dlrm_bundle("rmc3", RMC3)
