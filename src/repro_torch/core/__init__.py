# The paper's primary contribution: access-frequency-based data remapping,
# page-wise caching, and Algorithm-1 adaptive remapping for NAND-flash
# in-storage recommendation inference (RecFlash).
# (RecFlashEngine lives in repro_torch.core.engine — imported lazily to avoid a
# cycle with repro_torch.flashsim.)
from repro_torch.core.adaptive import AdaptiveHashTable, UpdateReport
from repro_torch.core.freq import AccessStats
from repro_torch.core.page_cache import PageLRU
from repro_torch.core.remap import Mapping, build_mapping, build_mapping_from_order
from repro_torch.core.triggers import PeriodTrigger, ThresholdTrigger

__all__ = [
    "AccessStats",
    "AdaptiveHashTable",
    "Mapping",
    "PageLRU",
    "PeriodTrigger",
    "ThresholdTrigger",
    "UpdateReport",
    "build_mapping",
    "build_mapping_from_order",
]
