"""Roofline terms of one rank's call (port of ``repro.launch.roofline``).

Hardware model: one NVIDIA H100 SXM5, by NVIDIA's published peaks (the
data sheet, not measured here): 989 TFLOP/s dense bf16 on the tensor
cores, 3.35 TB/s HBM3, 450 GB/s of NVLink per direction, 80 GB of HBM.

All three terms come from one rank's program (``launch.op_stats``, which
runs the plan's function on that rank's blocks):

    compute term    = flops_per_device / peak_flops
    memory term     = bytes_per_device / hbm_bw
    collective term = wire_bytes_per_device / link_bw

The reference derives them from XLA's optimized HLO (a fused program); the
port's counts are eager and unfused, so its memory term bounds a fused
program's from above. The peak memory is ``op_stats``' most live bytes:
the arguments, plus what the call made that was alive at once.
"""

from __future__ import annotations

import dataclasses

H100 = {
    "peak_flops": 989e12,     # dense bf16 FLOP/s per card (tensor cores)
    "hbm_bw": 3.35e12,        # HBM3 bytes/s per card
    "link_bw": 450e9,         # NVLink bytes/s per direction per card
    "hbm_bytes": 80e9,        # HBM capacity per card
}


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float | None = None   # 6ND-style useful FLOPs (global)
    useful_ratio: float | None = None  # model_flops / (flops * n_chips)
    collectives: dict | None = None
    memory: dict | None = None
    peak_flops: float = H100["peak_flops"]

    @property
    def t_bound(self) -> float:
        """Lower-bound step time if the dominant term were perfectly
        overlapped with everything else."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def roofline_fraction(self) -> float | None:
        """Useful-compute fraction of the dominant-term-bound step time."""
        if self.model_flops is None or self.t_bound == 0:
            return None
        n_chips = (self.model_flops / self.useful_ratio / self.flops_per_device
                   if self.useful_ratio else None)
        if not n_chips:
            return None
        ideal = self.model_flops / (n_chips * self.peak_flops)
        return ideal / self.t_bound

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["t_bound"] = self.t_bound
        frac = self.roofline_fraction()
        if frac is not None:
            d["roofline_fraction"] = frac
        return d


def analyze(stats: dict, n_chips: int, model_flops: float | None = None,
            hw: dict = H100) -> Roofline:
    """The three roofline terms of ``stats`` (``op_stats``' dict, or
    ``hlo_stats``' keys), one rank of ``n_chips``."""
    flops = float(stats["flops"])
    bytes_acc = float(stats["bytes"])
    wire = float(stats["total"]["wire_bytes"])
    t_compute = flops / hw["peak_flops"]
    t_memory = bytes_acc / hw["hbm_bw"]
    t_collective = wire / hw["link_bw"]
    bottleneck = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)), key=lambda kv: kv[1])[0]
    mem = None
    if "peak_bytes" in stats:
        mem = {"argument_bytes": int(stats["argument_bytes"]),
               "peak_bytes": int(stats["peak_bytes"]),
               "fits_hbm": bool(stats["peak_bytes"] < hw["hbm_bytes"])}
    useful = None
    if model_flops:
        useful = model_flops / max(flops * n_chips, 1.0)
    return Roofline(
        flops_per_device=flops, bytes_per_device=bytes_acc,
        wire_bytes_per_device=wire, t_compute=t_compute, t_memory=t_memory,
        t_collective=t_collective, bottleneck=bottleneck,
        model_flops=model_flops, useful_ratio=useful,
        collectives=stats["per_op"], memory=mem,
        peak_flops=hw["peak_flops"])
