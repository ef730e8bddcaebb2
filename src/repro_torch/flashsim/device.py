"""NAND flash device model — Table I timing + Table III part configs.

The read operation (paper §III-A, Fig. 4) has three stages:

  C/A stage   t_CA = (t_ALH + t_ALS - t_DS) + 5*t_WC + t_DS        (Eq. 1)
  page read   t_R  = array -> page buffer (part-dependent, Table III)
  data out    t_DO = t_RR + t_RC * N,  N = bytes fetched            (Eq. 2)

With Table I numbers: t_CA = 0.115 us, t_R(SLC) = 25 us and, for a 128 B
embedding vector, t_DO = 2.58 us — matching the paper's worked example
(2 vectors, 2 pages: 55.39 us; 2 vectors, 1 page: 30.275 us).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlashTiming:
    """Table I — timing parameters, microseconds."""

    t_alh: float = 0.005   # ALE hold
    t_als: float = 0.01    # ALE setup
    t_ds: float = 0.007    # data setup
    t_wc: float = 0.02     # write-cycle (command/address strobe)
    t_rr: float = 0.02     # ready -> RE# falling edge
    t_rc: float = 0.02     # read-cycle per byte on the IO bus

    @property
    def t_ca(self) -> float:
        """Eq. 1 — command/address stage."""
        return (self.t_alh + self.t_als - self.t_ds) + self.t_wc * 5 + self.t_ds

    def t_do(self, n_bytes: int) -> float:
        """Eq. 2 — data-out stage for ``n_bytes`` streamed over IO pins."""
        return self.t_rr + self.t_rc * n_bytes


@dataclasses.dataclass(frozen=True)
class FlashPart:
    """Table III — one NAND flash configuration.

    t_prog / t_erase are not in the paper's tables; they only matter for the
    online-remapping overhead (Fig. 14) and use public datasheet-typical
    values (documented assumption, DESIGN.md §2.1).
    """

    name: str
    page_bytes: int
    n_planes: int
    t_r: float              # us, array -> page buffer
    e_page_read: float      # uJ per page read
    die_area_mm2: float
    t_prog: float           # us, page program
    t_erase: float          # us, block erase
    pages_per_block: int = 256
    e_io_per_byte: float = 0.001     # uJ/byte on the IO bus (NVSim-scale)
    e_page_prog: float | None = None  # uJ; default = 2x read energy

    def __post_init__(self) -> None:
        if self.e_page_prog is None:
            object.__setattr__(self, "e_page_prog", 2.0 * self.e_page_read)

    def rewrite_latency_us(self, n_pages: int, n_blocks: int, t_ca: float,
                           plane_counts: np.ndarray | None = None) -> float:
        """Latency to read-modify-program ``n_pages`` + erase ``n_blocks``.

        Per page: C/A + array read (``t_r``, the old page is read back to
        merge unchanged slots) + program (``t_prog``). When a per-plane
        page-count vector is given, the ``t_r + t_prog`` core overlaps
        across planes (multi-plane program, the PD capability) and the
        total is ``max`` over planes; without one the pass is serial.
        Erases of retired blocks are serial either way (one block-erase
        command per block on the shared die). Single source for both the
        bulk remap cost (``SLSSimulator.remap_cost``) and the in-band
        program pass (``SLSSimulator.program_pass``), DESIGN.md §5.3.
        """
        core = self.t_r + self.t_prog
        if plane_counts is not None:
            per_plane = float(np.max(plane_counts, initial=0)) * core
        else:
            per_plane = n_pages * core
        return n_pages * t_ca + per_plane + n_blocks * self.t_erase


# Table III parts. Program/erase constants: SLC ~200us/2ms, TLC ~660us/3.5ms,
# QLC ~2ms/5ms (typical for the cited 8Gb SLC / 512Gb TLC / 1Tb QLC parts).
SLC = FlashPart("SLC", page_bytes=4 * 1024, n_planes=2, t_r=25.0,
                e_page_read=7.39, die_area_mm2=89.65,
                t_prog=200.0, t_erase=2_000.0)
TLC = FlashPart("TLC", page_bytes=16 * 1024, n_planes=2, t_r=60.0,
                e_page_read=69.06, die_area_mm2=128.64,
                t_prog=660.0, t_erase=3_500.0)
QLC = FlashPart("QLC", page_bytes=16 * 1024, n_planes=2, t_r=140.0,
                e_page_read=110.99, die_area_mm2=181.88,
                t_prog=2_000.0, t_erase=5_000.0)

PARTS = {"SLC": SLC, "TLC": TLC, "QLC": QLC}

TIMING = FlashTiming()


# -- fault injection (DESIGN.md §9) -----------------------------------------

# RBER scale per part: more bits per cell means a higher raw-bit-error rate
# at equal retention age (SLC << TLC << QLC). Order-of-magnitude shape from
# public NAND characterisation studies; the exact values are a documented
# modeling assumption like t_prog / t_erase above.
PART_FAIL_FACTOR = {"SLC": 1.0, "TLC": 4.0, "QLC": 16.0}

FAULT_EVENT_KINDS = ("device_fail", "channel_stall")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fleet fault at a simulated timestamp (DESIGN.md §9.2).

    ``device_fail`` — device ``device`` stops answering at ``t_us``
    (permanent): every read that would complete after ``t_us`` is lost.
    ``channel_stall`` — channel ``channel`` of the device (``None`` = all
    its channels) cannot *start* service inside
    ``[t_us, t_us + duration_us)``.
    """

    t_us: float
    kind: str = "device_fail"
    device: int = 0
    channel: int | None = None
    duration_us: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_EVENT_KINDS:
            raise ValueError(f"unknown fault event kind {self.kind!r}; "
                             f"have {FAULT_EVENT_KINDS}")
        if self.t_us < 0:
            raise ValueError("t_us must be >= 0")
        if self.kind == "channel_stall" and self.duration_us <= 0:
            raise ValueError("channel_stall needs a positive duration_us")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded, fully deterministic flash-fault model (DESIGN.md §9.1).

    **Read-retry ladder.** A page read's first attempt fails with
    probability ``p0 = read_fail_base * PART_FAIL_FACTOR[part] *
    (1 + retention_rate * retention_age_days)`` (clamped to 0.95) — the
    post-ECC probability that the raw bit errors exceed the base
    correction strength. Retry rung ``j`` re-reads with a stepped read
    voltage and fails with ``p0 * retry_decay**j``; every rung re-pays
    the part's ``t_r``. After ``max_retries`` rungs ECC declares the read
    **uncorrectable**: the lookups riding it error out, the time is still
    paid. A single uniform draw per page read drives the whole ladder
    (rung ``j`` fails iff ``u < p0 * retry_decay**j``), which makes the
    retry depth vectorisable and monotone non-decreasing in ``p0`` for a
    fixed seed.

    **Grown bad blocks.** ``bad_block_frac`` of each device's blocks are
    marked grown-bad at build time (seeded choice, no per-access RNG);
    a read landing in one pays a deterministic FTL redirection — one
    extra ``t_CA + t_R`` to the replacement block.

    **Events.** ``events`` injects channel stalls and whole-device
    failures at simulated timestamps (:class:`FaultEvent`); they are
    consumed by the serving replay, not the device simulator.

    All randomness derives from ``seed`` (explicit, RL002-clean);
    ``stream`` is the substream identity (device index in a fleet) so
    devices draw independent but reproducible fault sequences. A
    disabled config (``enabled=False`` or all-zero rates) is bit-identical
    to the fault-free simulator.
    """

    enabled: bool = True
    seed: int = 0
    read_fail_base: float = 0.0      # P(first attempt fails) on SLC, age 0
    retention_age_days: float = 0.0
    retention_rate: float = 0.05     # fail-prob growth per day of retention
    retry_decay: float = 0.5         # per-rung fail-prob multiplier
    max_retries: int = 8             # ladder depth before ECC gives up
    bad_block_frac: float = 0.0      # grown-bad share of blocks
    events: tuple = ()               # FaultEvent tuple
    stream: int = 0                  # RNG substream (device identity)

    def __post_init__(self) -> None:
        if not 0.0 <= self.read_fail_base < 1.0:
            raise ValueError("read_fail_base must be in [0, 1)")
        if self.retention_age_days < 0 or self.retention_rate < 0:
            raise ValueError("retention age/rate must be >= 0")
        if not 0.0 < self.retry_decay <= 1.0:
            raise ValueError("retry_decay must be in (0, 1]")
        if self.max_retries < 1:
            raise ValueError("max_retries must be >= 1")
        if not 0.0 <= self.bad_block_frac < 1.0:
            raise ValueError("bad_block_frac must be in [0, 1)")
        if self.stream < 0:
            raise ValueError("stream must be >= 0")
        object.__setattr__(self, "events", tuple(self.events))

    @property
    def active(self) -> bool:
        """True iff the config can change anything at all."""
        return self.enabled and (self.read_fail_base > 0.0
                                 or self.bad_block_frac > 0.0
                                 or bool(self.events))

    def read_fail_prob(self, part: "FlashPart") -> float:
        """First-attempt read-failure probability for ``part`` at the
        configured retention age (the ladder's ``p0``)."""
        p = (self.read_fail_base * PART_FAIL_FACTOR.get(part.name, 1.0)
             * (1.0 + self.retention_rate * self.retention_age_days))
        return min(p, 0.95)

    def bad_page_mask(self, n_page_ids: int,
                      pages_per_block: int) -> np.ndarray:
        """Per-page grown-bad flag over a device's page-id namespace.

        Deterministic from ``(seed, stream)`` — the grown-bad-block table
        is device state built once, not a per-access draw.
        """
        n_blocks = max(1, -(-n_page_ids // pages_per_block))
        bad_blocks = np.zeros(n_blocks, dtype=bool)
        # ceil: any nonzero frac marks at least one block, even on
        # tables smaller than 1/frac blocks
        n_bad = int(np.ceil(self.bad_block_frac * n_blocks))
        if n_bad:
            rng = np.random.default_rng((self.seed, self.stream, 1))
            bad_blocks[rng.choice(n_blocks, size=n_bad, replace=False)] = True
        pages = np.arange(n_page_ids, dtype=np.int64) // pages_per_block
        return bad_blocks[pages]

    def retry_seed(self, substream: int) -> tuple:
        """Seed tuple for one simulator's retry-draw generator.

        ``substream`` separates the channel forks of one device; the
        device identity itself is ``stream``.
        """
        return (self.seed, self.stream, 2, substream)

    def for_device(self, device: int) -> "FaultConfig":
        """Device-local view: own RNG substream, own events only."""
        return dataclasses.replace(
            self, stream=device,
            events=tuple(e for e in self.events if e.device == device))

    def for_replica(self, replica: int) -> "FaultConfig":
        """Replica-device view: RBER/bad-block model active on its own
        substream, injected events stripped (replicas are the recovery
        path; a scenario that fails them too should model them as
        primaries)."""
        return dataclasses.replace(self, stream=10_000 + replica, events=())

    @property
    def device_fail_at_us(self) -> float:
        """Earliest whole-device failure time (inf = never fails)."""
        fails = [e.t_us for e in self.events if e.kind == "device_fail"]
        return min(fails) if fails else float("inf")

    def stall_windows(self) -> list:
        """``(channel, t0_us, t1_us)`` no-start windows, sorted by start."""
        return sorted(((e.channel, e.t_us, e.t_us + e.duration_us)
                       for e in self.events if e.kind == "channel_stall"),
                      key=lambda w: (w[1], w[2]))

    # -- serialization (DeploymentConfig round-trip) ------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["events"] = [dataclasses.asdict(e) for e in self.events]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultConfig":
        d = dict(d)
        d["events"] = tuple(FaultEvent(**e) for e in d.get("events", ()))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Page-wise SRAM cache in the SSD controller (paper §III-C2).

    128 KB SRAM, 0.44 mm^2 @ 28 nm. Hits bypass the flash array entirely;
    we charge a small SRAM access time/energy per vector served.
    """

    sram_bytes: int = 128 * 1024
    t_sram_vec: float = 0.05        # us per vector served from SRAM
    e_sram_per_byte: float = 1e-5   # uJ/byte (28nm SRAM read, NVSim-scale)

    def n_slots(self, page_bytes: int) -> int:
        return max(1, self.sram_bytes // page_bytes)
