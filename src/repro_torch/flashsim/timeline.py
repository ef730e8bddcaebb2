"""Trace-exact SLS simulator over the NAND device model (paper §IV setup).

Per embedding access the pipeline is:

  1. page-wise SRAM cache probe (RecFlash ``P$`` only) — a hit serves the
     vector from controller SRAM, no flash activity;
  2. page-buffer probe — each plane's page buffer holds the last page it
     latched; a match costs only the data-out stage;
  3. page read — ``t_CA + t_R`` on that plane.

Policy capability model (faithful to paper §III):

* Baselines (RecSSD / RM-SSD) issue lookups **serially in arrival order**
  (Fig. 4a: two vectors in two pages cost ``2 x (t_CA + t_R + t_DO)``), with
  no multi-plane overlap. RecSSD drains the page buffer sequentially from
  byte 0 to the needed vector; RM-SSD reads only the vector's slot
  (selective read, §III-B).
* RecFlash's FTL knows the whole SLS command, so it **coalesces** accesses
  by (plane, page) — remapping is what makes that profitable — and with PD
  it issues **multi-plane reads** whose ``t_R`` overlap across planes
  (§III-C1: "plane-level parallelism, allowing more page buffers to be
  active"). With P$ it adds the page-wise LRU cache (§III-C2).

Latency for one batch:

  T = sum(t_CA over page reads)
    + [max over planes if plane_parallel else sum](per-plane t_R totals)
    + sum(t_DO over flash-served lookups) + sum(t_SRAM over cache hits)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.page_cache import PageLRU
from repro_torch.core.remap import Mapping
from repro_torch.flashsim.device import (CacheConfig, FaultConfig, FlashPart,
                                   FlashTiming, TIMING)


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """An access policy = mapping mode + controller capabilities."""

    name: str
    mapping_mode: str        # baseline | af | af_pd
    sequential_drain: bool   # True -> RecSSD-style drain from byte 0
    use_cache: bool          # True -> page-wise LRU in controller SRAM
    coalesce: bool           # sort each SLS command's accesses by (plane,page)
    plane_parallel: bool     # overlap t_R across planes (PD)


POLICIES = {
    "recssd": PolicyConfig("recssd", "baseline", True, False, False, False),
    "rmssd": PolicyConfig("rmssd", "baseline", False, False, False, False),
    "recflash_af": PolicyConfig("recflash_af", "af", False, False, True, False),
    "recflash_af_pd": PolicyConfig("recflash_af_pd", "af_pd", False, False,
                                   True, True),
    "recflash": PolicyConfig("recflash", "af_pd", False, True, True, True),
}

# Default serving comparison set: the three end-to-end systems the paper
# evaluates (ablation stages excluded), in POLICIES order. Single source for
# every driver/benchmark policy tuple — do not re-declare it.
SERVING_POLICIES: tuple = tuple(
    n for n in POLICIES if not n.startswith("recflash_"))


@dataclasses.dataclass
class ProgramResult:
    """Outcome of one in-band page-program pass (online remap rewrite)."""

    latency_us: float = 0.0
    energy_uj: float = 0.0
    n_pages: int = 0
    n_blocks: int = 0
    bytes_programmed: int = 0


@dataclasses.dataclass
class SimResult:
    latency_us: float = 0.0
    energy_uj: float = 0.0        # total: array + IO bus + SRAM
    read_energy_uj: float = 0.0   # array reads + SRAM only (paper Fig. 11 scope)
    n_lookups: int = 0
    n_page_reads: int = 0
    n_buffer_hits: int = 0
    n_cache_hits: int = 0
    bytes_out: int = 0
    # fault-injection accounting (DESIGN.md §9.1; zero/None with faults off)
    n_retries: int = 0            # extra t_R re-pays on the retry ladder
    n_uncorrectable: int = 0      # page reads ECC gave up on
    n_badblock_reads: int = 0     # grown-bad-block FTL redirections
    n_failed_lookups: int = 0     # accesses riding an uncorrectable read
    retry_hist: np.ndarray | None = None   # (max_retries+1,) reads by depth
    # per-access failed flag in this call's input order (not merged —
    # callers consume it per batch for request attribution)
    failed: np.ndarray | None = None

    def merge(self, other: "SimResult") -> "SimResult":
        if self.retry_hist is None:
            hist = None if other.retry_hist is None else other.retry_hist.copy()
        elif other.retry_hist is None:
            hist = self.retry_hist.copy()
        else:
            hist = self.retry_hist + other.retry_hist
        return SimResult(
            self.latency_us + other.latency_us,
            self.energy_uj + other.energy_uj,
            self.read_energy_uj + other.read_energy_uj,
            self.n_lookups + other.n_lookups,
            self.n_page_reads + other.n_page_reads,
            self.n_buffer_hits + other.n_buffer_hits,
            self.n_cache_hits + other.n_cache_hits,
            self.bytes_out + other.bytes_out,
            n_retries=self.n_retries + other.n_retries,
            n_uncorrectable=self.n_uncorrectable + other.n_uncorrectable,
            n_badblock_reads=self.n_badblock_reads + other.n_badblock_reads,
            n_failed_lookups=self.n_failed_lookups + other.n_failed_lookups,
            retry_hist=hist,
        )

    @property
    def reads_per_lookup(self) -> float:
        return self.n_page_reads / max(1, self.n_lookups)


class SLSSimulator:
    """Stateful SLS access simulator for one device + policy + table set."""

    def __init__(self, part: FlashPart, policy: PolicyConfig,
                 mappings: list[Mapping], timing: FlashTiming = TIMING,
                 cache_cfg: CacheConfig | None = None,
                 fault: FaultConfig | None = None,
                 fault_stream: int = 0) -> None:
        self.part = part
        self.policy = policy
        self.timing = timing
        self.mappings = mappings
        self.cache_cfg = cache_cfg or CacheConfig()
        self.cache = (PageLRU(self.cache_cfg.n_slots(part.page_bytes))
                      if policy.use_cache else None)
        # page buffer state per plane: last page latched (-1 = empty) and,
        # for sequential drain, how many bytes have been streamed already.
        self._buffer = np.full(part.n_planes, -1, dtype=np.int64)
        self._drain_pos = np.zeros(part.n_planes, dtype=np.int64)
        # cached int64 window-id base for the coalescing lexsort (grown on
        # demand) — avoids a per-call arange allocation on the hot path.
        self._arange = np.arange(4096, dtype=np.int64)
        # page-id namespace must be unique across tables
        self._page_offset = np.zeros(len(mappings), dtype=np.int64)
        off = 0
        for t, m in enumerate(mappings):
            self._page_offset[t] = off
            off += m.n_pages + 1
        self._n_page_ids = off   # size of the global page-id namespace
        # fault-injection state (DESIGN.md §9.1). All derived from the
        # explicit FaultConfig seed (RL002): the grown-bad-block table is
        # built once here; the retry-draw generator is (re)seeded by
        # reset_state so identically-prepared replays draw identically.
        self.fault = fault if (fault is not None and fault.active) else None
        self._fault_stream = fault_stream
        if self.fault is not None:
            self._fail_p = self.fault.read_fail_prob(part)
            self._bad_page = (self.fault.bad_page_mask(
                max(1, self._n_page_ids), part.pages_per_block)
                if self.fault.bad_block_frac > 0.0 else None)
            self._buffer_failed = np.zeros(part.n_planes, dtype=bool)
            self._fault_rng = np.random.default_rng(
                self.fault.retry_seed(fault_stream))
        else:
            self._fail_p = 0.0
            self._bad_page = None
            self._buffer_failed = None
            self._fault_rng = None

    def reset_state(self) -> None:
        self._buffer[:] = -1
        self._drain_pos[:] = 0
        if self.cache is not None:
            self.cache.clear()
        if self.fault is not None and self._buffer_failed is not None:
            self._buffer_failed[:] = False
            self._fault_rng = np.random.default_rng(
                self.fault.retry_seed(self._fault_stream))

    def fork(self, cache_cfg: CacheConfig | None = None,
             fault_stream: int | None = None) -> "SLSSimulator":
        """Independent simulator over the *same* mappings list.

        The fork gets private planes/page buffers/cache state (fresh, not
        copied) but shares the FTL mapping objects, so an online
        ``replace_mapping`` on any fork is visible to all of them. This is
        the building block for concurrency views of one device: per-channel
        sims slice the controller P$ budget (``RecFlashEngine.
        channel_sims``), while multi-SSD scale-out gives each *device* its
        own full-budget simulator instead (DESIGN.md §6).
        """
        return SLSSimulator(self.part, self.policy, self.mappings,
                            self.timing, cache_cfg or self.cache_cfg,
                            fault=self.fault,
                            fault_stream=(self._fault_stream
                                          if fault_stream is None
                                          else fault_stream))

    def replace_mapping(self, table: int, mapping: Mapping) -> None:
        """Swap in a new remapped layout (after online remapping)."""
        self.mappings[table] = mapping
        self.reset_state()

    def run(self, tables: np.ndarray, rows: np.ndarray,
            window: int = 0, force_exact: bool = False) -> SimResult:
        """Simulate a stream of SLS accesses. Returns accumulated totals.

        ``window`` is the SLS command size (accesses per inference request);
        coalescing policies sort accesses by (plane, page) within each
        window. ``window=0`` treats the whole call as one command.

        Every policy takes a vectorised fast path (DESIGN.md §2.3) —
        no-cache policies via the page-buffer segment pass, the P$ policy
        via the reuse-distance LRU evaluator feeding its miss sub-stream
        through the same pass. Identical results to the per-access loop
        (property-tested, including carried device state);
        ``force_exact`` keeps the exact loop for verification.
        """
        if force_exact and self.fault is not None:
            raise ValueError(
                "fault injection is vectorised-only (DESIGN.md §9.1); "
                "disable the FaultConfig to use force_exact")
        tables = np.asarray(tables, dtype=np.int64).ravel()
        rows = np.asarray(rows, dtype=np.int64).ravel()
        n = rows.size
        t = self.timing
        part = self.part
        t_ca = t.t_ca
        t_rr, t_rc = t.t_rr, t.t_rc
        pol = self.policy
        cache = self.cache
        ccfg = self.cache_cfg
        buffer = self._buffer
        drain_pos = self._drain_pos

        # resolve physical addresses vectorised, per table
        planes = np.empty(n, dtype=np.int64)
        pages = np.empty(n, dtype=np.int64)
        slots = np.empty(n, dtype=np.int64)
        vec_bytes = np.empty(n, dtype=np.int64)
        for tid in np.unique(tables):
            m = self.mappings[tid]
            sel = tables == tid
            p, g, s = m.lookup(rows[sel])
            planes[sel] = p
            pages[sel] = g + self._page_offset[tid]
            slots[sel] = s
            vec_bytes[sel] = m.vec_bytes

        if pol.coalesce:
            wid = None
            if window:
                if self._arange.size < n:
                    self._arange = np.arange(max(n, 2 * self._arange.size),
                                             dtype=np.int64)
                wid = self._arange[:n] // window
            if not force_exact and not pol.sequential_drain:
                # collapsed fast path: coalescing groups equal
                # (window, plane, page) accesses anyway, so group first
                # (counting sort — no O(n log n) per-access sort) and run
                # every downstream pass on the collapsed stream.
                return self._run_coalesced(planes, pages, vec_bytes, wid, n)
            if window:
                order = np.lexsort((slots, pages, planes, wid))
            else:
                # window=0: one command, the wid key is constant — drop it
                # (lexsort is stable, so the order is unchanged).
                order = np.lexsort((slots, pages, planes))
            planes, pages, slots, vec_bytes = (
                planes[order], pages[order], slots[order], vec_bytes[order])

        if not force_exact:
            if self.cache is None:
                return self._run_vectorized(planes, pages, slots, vec_bytes)
            return self._run_vectorized_cached(planes, pages, slots,
                                               vec_bytes)

        res = SimResult(n_lookups=int(n))
        plane_tr = np.zeros(part.n_planes, dtype=np.float64)
        n_reads = 0
        buf_hits = 0
        cache_hits = 0
        do_time = 0.0
        sram_time = 0.0
        bytes_out = 0
        e_sram = 0.0
        seq_drain = pol.sequential_drain

        for pl, pg, sl, vb in zip(planes.tolist(), pages.tolist(),
                                  slots.tolist(), vec_bytes.tolist(), strict=True):
            if cache is not None and cache.access(pg):
                cache_hits += 1
                sram_time += ccfg.t_sram_vec
                e_sram += vb * ccfg.e_sram_per_byte
                continue
            if buffer[pl] != pg:
                buffer[pl] = pg
                drain_pos[pl] = 0
                plane_tr[pl] += part.t_r
                n_reads += 1
            else:
                buf_hits += 1
            if seq_drain:
                # one sequential stream per latched page: drain from the
                # current position up to the end of the needed vector.
                end = (sl + 1) * vb
                nbytes = max(0, end - int(drain_pos[pl]))
                drain_pos[pl] = max(int(drain_pos[pl]), end)
            else:
                nbytes = vb
            do_time += t_rr + t_rc * nbytes
            bytes_out += nbytes

        res.n_page_reads = n_reads
        res.n_buffer_hits = buf_hits
        res.n_cache_hits = cache_hits
        res.bytes_out = bytes_out
        tr_total = (float(plane_tr.max(initial=0.0)) if pol.plane_parallel
                    else float(plane_tr.sum()))
        res.latency_us = n_reads * t_ca + tr_total + do_time + sram_time
        res.read_energy_uj = n_reads * part.e_page_read + e_sram
        res.energy_uj = res.read_energy_uj + bytes_out * part.e_io_per_byte
        return res

    def _sample_retries(self, n_reads: int) -> tuple[np.ndarray, np.ndarray]:
        """Vectorised retry ladder: (retry depth, uncorrectable) per read.

        One uniform draw ``u`` per page read drives every rung: rung ``j``
        fails iff ``u < p0 * decay**j`` (DESIGN.md §9.1), so the depth is
        a closed-form log and — for a fixed generator state — monotone
        non-decreasing in ``p0``. Depth is clamped to ``max_retries``;
        deeper demand means ECC gives up (uncorrectable).
        """
        f = self.fault
        rng = self._fault_rng
        k = np.zeros(n_reads, dtype=np.int64)
        uce = np.zeros(n_reads, dtype=bool)
        p0 = self._fail_p
        if f is None or rng is None or p0 <= 0.0 or n_reads == 0:
            return k, uce
        u = rng.random(n_reads)
        failing = u < p0
        if not failing.any():
            return k, uce
        if f.retry_decay >= 1.0:
            # no escalation: a failing read fails every rung
            k[failing] = f.max_retries
            uce[failing] = True
            return k, uce
        with np.errstate(divide="ignore"):
            depth = np.ceil(np.log(u[failing] / p0)
                            / np.log(f.retry_decay))
        # u == 0 gives infinite depth — clamp before the int cast; a
        # failing first attempt costs at least one retry either way.
        depth = np.clip(depth, 1, f.max_retries + 1)
        kd = depth.astype(np.int64)
        uce[failing] = kd > f.max_retries
        k[failing] = np.minimum(kd, f.max_retries)
        return k, uce

    def _fault_plane(self, p: int, pp: np.ndarray, r: np.ndarray,
                     plane_tr: np.ndarray, res: SimResult,
                     hist: np.ndarray) -> tuple[np.ndarray, int, int]:
        """Fault pass for one plane of a (possibly collapsed) stream.

        Samples the retry ladder for the plane's page reads, adds their
        extra ``t_R`` to ``plane_tr`` (retries extend the plane's array
        busy time, so multi-plane overlap still applies), looks up
        grown-bad-block redirections, and updates the counters/histogram.
        Returns ``(failed, n_bad, n_extra_reads)``: the per-position
        failed mask (positions whose page-buffer segment head was
        uncorrectable — segment 0 rides the previous call's latched
        page), the redirection count (each owes a ``t_CA`` the caller
        charges), and the total extra array reads (energy).
        """
        part = self.part
        buffer_failed = self._buffer_failed
        assert buffer_failed is not None   # only called with faults active
        read_pages = pp[r]
        k, uce = self._sample_retries(read_pages.size)
        extra_tr = int(k.sum())
        n_bad = (int(self._bad_page[read_pages].sum())
                 if self._bad_page is not None and read_pages.size else 0)
        plane_tr[p] += float(extra_tr + n_bad) * part.t_r
        res.n_retries += extra_tr
        res.n_uncorrectable += int(uce.sum())
        res.n_badblock_reads += n_bad
        hist += np.bincount(k, minlength=hist.size)
        head_failed = np.concatenate(([buffer_failed[p]], uce))
        seg = np.cumsum(r)
        failed = head_failed[seg]
        buffer_failed[p] = bool(head_failed[seg[-1]])
        return failed, n_bad, extra_tr + n_bad

    def _run_vectorized(self, planes: np.ndarray, pages: np.ndarray,
                        slots: np.ndarray,
                        vec_bytes: np.ndarray) -> SimResult:
        """Fast path for no-cache policies — bitwise identical to the loop."""
        n = pages.size
        part = self.part
        t = self.timing
        res = SimResult(n_lookups=int(n))
        if n == 0:
            return res
        buffer = self._buffer
        drain_pos = self._drain_pos
        fault = self.fault
        if fault is not None:
            failed = np.zeros(n, dtype=bool)
            hist = np.zeros(fault.max_retries + 1, dtype=np.int64)
            f_bad = f_extra = 0

        # page-read positions: page differs from the previous access on the
        # same plane (first access per plane compares against buffer state).
        reads = np.empty(n, dtype=bool)
        plane_tr = np.zeros(part.n_planes, dtype=np.float64)
        bytes_out = 0
        for p in range(part.n_planes):
            idx = np.flatnonzero(planes == p)
            if idx.size == 0:
                continue
            pp = pages[idx]
            r = np.empty(idx.size, dtype=bool)
            r[0] = pp[0] != buffer[p]
            r[1:] = pp[1:] != pp[:-1]
            reads[idx] = r
            plane_tr[p] = float(r.sum()) * part.t_r
            if fault is not None:
                fl, nb, nx = self._fault_plane(p, pp, r, plane_tr, res, hist)
                failed[idx] = fl
                f_bad += nb
                f_extra += nx
            if self.policy.sequential_drain:
                # Drained-bytes model: within each buffer-residency segment
                # (starts at a page read), the stream position is the running
                # max of vector end offsets; each access drains from the
                # current position to its own end. Vectorised as a keyed
                # segment-cummax: key = seg_id * base + end, base > any end.
                end = (slots[idx] + 1) * vec_bytes[idx]
                seg = np.cumsum(r)                 # segment id per access
                carry = np.int64(drain_pos[p]) if not r[0] else np.int64(0)
                base = np.int64(end.max()) + carry + 1
                keyed = seg * base + end
                shifted = np.empty_like(keyed)
                shifted[0] = seg[0] * base + carry  # carry-in drain position
                shifted[1:] = keyed[:-1]
                cum_prev = np.maximum.accumulate(shifted)
                # a carried max from an older segment means nothing has been
                # drained in this segment yet.
                prev_drained = np.where(cum_prev // base == seg,
                                        cum_prev % base, 0)
                nb = np.maximum(0, end - prev_drained)
                bytes_out += int(nb.sum())
                res.latency_us += t.t_rr * idx.size + t.t_rc * float(nb.sum())
                in_last = seg == seg[-1]
                last_max = int(end[in_last].max())
                if seg[-1] == seg[0] and not r[0]:
                    last_max = max(last_max, int(carry))
                drain_pos[p] = last_max
            else:
                nb_total = int(vec_bytes[idx].sum())
                bytes_out += nb_total
                res.latency_us += t.t_rr * idx.size + t.t_rc * nb_total
                drain_pos[p] = 0
            buffer[p] = pages[idx][-1]

        n_reads = int(reads.sum())
        res.n_page_reads = n_reads
        res.n_buffer_hits = int(n - n_reads)
        res.bytes_out = bytes_out
        tr_total = (float(plane_tr.max(initial=0.0))
                    if self.policy.plane_parallel else float(plane_tr.sum()))
        res.latency_us += n_reads * t.t_ca + tr_total
        res.read_energy_uj = n_reads * part.e_page_read
        res.energy_uj = res.read_energy_uj + bytes_out * part.e_io_per_byte
        if fault is not None:
            # bad-block redirections are full read commands (extra t_CA);
            # retries and redirections alike re-pay array read energy.
            # Uncorrectable reads still stream their (garbage) data out —
            # the controller answers with an error flag, not silence — so
            # t_DO/bytes accounting above is unchanged.
            res.latency_us += f_bad * t.t_ca
            e_extra = float(f_extra) * part.e_page_read
            res.read_energy_uj += e_extra
            res.energy_uj += e_extra
            res.retry_hist = hist
            res.failed = failed
            res.n_failed_lookups = int(failed.sum())
        return res

    def _run_coalesced(self, planes: np.ndarray, pages: np.ndarray,
                       vec_bytes: np.ndarray, wid: np.ndarray | None,
                       n: int) -> SimResult:
        """Fast path for coalescing, non-drain policies (DESIGN.md §2.3).

        Coalescing sorts each window's accesses by (plane, page), so equal
        pages form contiguous runs; every downstream quantity is a run
        aggregate. Group accesses into distinct (window, plane, page) keys
        with a counting sort (O(n + K); comparison-sort fallback when the
        key space K outgrows the stream), then:

        * P$ lane: the collapsed page sequence IS the run-collapsed cache
          stream — the reuse-distance evaluator scores run heads, run tails
          are distance-0 hits, and only head *misses* reach the flash;
        * page-buffer pass on the collapsed stream with multiplicities
          (identical integer totals, hence identical floats, to the
          per-access pass on the sorted stream).
        """
        res = SimResult(n_lookups=int(n))
        if n == 0:
            return res
        npl = np.int64(self.part.n_planes)
        pid = np.int64(self._n_page_ids)
        key = planes * pid + pages
        if wid is not None:
            key += wid * (npl * pid)
            k_space = (int(wid[-1]) + 1) * int(npl * pid)
        else:
            k_space = int(npl * pid)
        fault = self.fault
        elem_of = None   # per-access element index (fault expansion only)
        if k_space <= max(4 * n, 1 << 16):
            counts = np.bincount(key, minlength=k_space)
            present = np.flatnonzero(counts)
            cnt = counts[present]
            vbg = np.zeros(k_space, dtype=np.int64)
            vbg[key] = vec_bytes          # constant within a page's table
            vbg = vbg[present]
            gplane = (present // pid) % npl
            gpage = present % pid
            if fault is not None:
                elem_idx = np.zeros(k_space, dtype=np.int64)
                elem_idx[present] = np.arange(present.size, dtype=np.int64)
                elem_of = elem_idx[key]
        else:
            order = np.argsort(key, kind="stable")
            ks = key[order]
            head = np.empty(n, dtype=bool)
            head[0] = True
            np.not_equal(ks[1:], ks[:-1], out=head[1:])
            starts = np.flatnonzero(head)
            cnt = np.diff(np.append(starts, n))
            sel = order[head]
            gplane, gpage, vbg = planes[sel], pages[sel], vec_bytes[sel]
            if fault is not None:
                elem_of = np.empty(n, dtype=np.int64)
                elem_of[order] = np.cumsum(head) - 1
        if self.cache is None:
            self._plane_pass(res, gplane, gpage, vbg, cnt)
            if fault is not None and res.failed is not None:
                res.failed = res.failed[elem_of]
            return res
        hits = self.cache.bulk_access(gpage)
        # run tails (coalesced repeats of a head) are distance-0 hits the
        # collapsed stream never shows the PageLRU — patch its counters so
        # they match the per-access loop exactly.
        self.cache.hits += int(n) - int(cnt.size)
        miss = ~hits
        self._plane_pass(res, gplane[miss], gpage[miss], vbg[miss],
                         np.ones(int(miss.sum()), dtype=np.int64))
        if fault is not None and res.failed is not None:
            # an uncorrectable page still enters the P$ (garbage payload,
            # DESIGN.md §9.1), so the run tails riding a failed head fail
            # with it — the access-space expansion weights them in.
            elem_failed = np.zeros(cnt.size, dtype=bool)
            elem_failed[np.flatnonzero(miss)[res.failed]] = True
            res.failed = elem_failed[elem_of]
            res.n_failed_lookups = int(res.failed.sum())
        n_hits = int(n) - int(miss.sum())
        res.n_cache_hits = n_hits
        ccfg = self.cache_cfg
        res.latency_us += n_hits * ccfg.t_sram_vec
        e_sram = float(int((cnt * vbg).sum()) - int(vbg[miss].sum())) \
            * ccfg.e_sram_per_byte
        res.read_energy_uj += e_sram
        res.energy_uj += e_sram
        return res

    def _plane_pass(self, res: SimResult, planes: np.ndarray,
                    pages: np.ndarray, vb: np.ndarray,
                    counts: np.ndarray) -> None:
        """Weighted page-buffer pass over a collapsed access stream.

        ``counts[i]`` raw accesses coalesce onto collapsed element ``i``
        (adjacent elements never share a page within one window, so a page
        read happens exactly at collapsed page transitions). Accumulates
        into ``res`` the same totals — field by field, in the same float
        order — as :meth:`_run_vectorized` over the expanded stream.
        """
        part, t = self.part, self.timing
        buffer, drain_pos = self._buffer, self._drain_pos
        n_reads = 0
        n_acc_total = 0
        plane_tr = np.zeros(part.n_planes, dtype=np.float64)
        bytes_out = 0
        fault = self.fault
        if fault is not None:
            failed = np.zeros(pages.size, dtype=bool)
            hist = np.zeros(fault.max_retries + 1, dtype=np.int64)
            f_bad = f_extra = 0
        for p in range(part.n_planes):
            idx = np.flatnonzero(planes == p)
            if idx.size == 0:
                continue
            pp = pages[idx]
            r = np.empty(idx.size, dtype=bool)
            r[0] = pp[0] != buffer[p]
            np.not_equal(pp[1:], pp[:-1], out=r[1:])
            plane_tr[p] = float(r.sum()) * part.t_r
            if fault is not None:
                fl, nb, nx = self._fault_plane(p, pp, r, plane_tr, res, hist)
                failed[idx] = fl
                f_bad += nb
                f_extra += nx
            n_reads += int(r.sum())
            cj = counts[idx]
            n_acc = int(cj.sum())
            n_acc_total += n_acc
            nb_total = int((cj * vb[idx]).sum())
            bytes_out += nb_total
            res.latency_us += t.t_rr * n_acc + t.t_rc * nb_total
            drain_pos[p] = 0
            buffer[p] = pp[-1]
        res.n_page_reads = n_reads
        res.n_buffer_hits = n_acc_total - n_reads
        res.bytes_out = bytes_out
        tr_total = (float(plane_tr.max(initial=0.0))
                    if self.policy.plane_parallel else float(plane_tr.sum()))
        res.latency_us += n_reads * t.t_ca + tr_total
        res.read_energy_uj = n_reads * part.e_page_read
        res.energy_uj = res.read_energy_uj + bytes_out * part.e_io_per_byte
        if fault is not None:
            res.latency_us += f_bad * t.t_ca
            e_extra = float(f_extra) * part.e_page_read
            res.read_energy_uj += e_extra
            res.energy_uj += e_extra
            res.retry_hist = hist
            # element-space mask: the caller (_run_coalesced) expands it
            # to the per-access stream and recounts failed lookups.
            res.failed = failed
            res.n_failed_lookups = int(counts[failed].sum())

    def _run_vectorized_cached(self, planes: np.ndarray,
                               pages: np.ndarray, slots: np.ndarray,
                               vec_bytes: np.ndarray) -> SimResult:
        """Fast path for the P$ policy (DESIGN.md §2.3).

        The whole-stream LRU hit mask comes from the reuse-distance bulk
        evaluator (``PageLRU.bulk_access``: an access hits iff fewer than C
        distinct pages were touched since its previous occurrence), then
        the *miss* sub-stream — the only accesses that reach the flash —
        goes through the same no-cache vectorised path. Identical results
        to the exact loop, including carried cache and buffer state.
        """
        cache = self.cache
        assert cache is not None           # P$ policies always build one
        hits = cache.bulk_access(pages)
        miss = ~hits
        res = self._run_vectorized(planes[miss], pages[miss], slots[miss],
                                   vec_bytes[miss])
        if self.fault is not None:
            # expand the miss-substream failed mask to the full stream;
            # cache hits never fail here (n_failed_lookups unchanged).
            full = np.zeros(pages.size, dtype=bool)
            if res.failed is not None:
                full[np.flatnonzero(miss)] = res.failed
            res.failed = full
        n_hits = int(hits.sum())
        res.n_lookups = int(pages.size)
        res.n_cache_hits = n_hits
        ccfg = self.cache_cfg
        res.latency_us += n_hits * ccfg.t_sram_vec
        e_sram = float(vec_bytes[hits].sum()) * ccfg.e_sram_per_byte
        res.read_energy_uj += e_sram
        res.energy_uj += e_sram
        return res

    # -- remapping overhead (paper §III-C4, Fig. 7/14; DESIGN.md §5.3) ------
    def remap_cost(self, n_rows: int, vec_bytes: int) -> tuple[float, float]:
        """Latency (us) and energy (uJ) to physically rewrite ``n_rows``.

        Read old pages + program new pages + erase retired blocks, serially
        — the bulk (stop-the-world) accounting ``Deployment.step_day``
        charges as a lump sum. The request-level lane instead issues the
        rewrite through :meth:`program_pass` so it competes with reads.
        """
        part = self.part
        vpp = max(1, part.page_bytes // vec_bytes)
        n_pages = -(-n_rows // vpp)
        n_blocks = -(-n_pages // part.pages_per_block)
        lat = part.rewrite_latency_us(n_pages, n_blocks, self.timing.t_ca)
        e_prog = part.e_page_prog
        assert e_prog is not None          # set by FlashPart.__post_init__
        energy = n_pages * (part.e_page_read + e_prog)
        return lat, energy

    def program_pass(self, plane_counts: np.ndarray,
                     n_blocks: int = 0) -> ProgramResult:
        """In-band page-program traffic for an online remap (DESIGN.md §5.3).

        ``plane_counts[p]`` pages are rewritten on plane ``p``. The pass
        occupies this simulator's channel for ``latency_us``: per page C/A +
        read-back (``t_r``) + program (``t_prog``), with the read/program
        core overlapped across planes iff the policy has multi-plane
        capability (``plane_parallel`` — same capability gate as reads),
        plus one serial block erase per retired block. Programs trash the
        device read state (page buffers latch programmed pages, the P$ may
        hold stale pre-move copies), so the pass resets it — the post-remap
        warm-up is part of the in-band cost.
        """
        plane_counts = np.asarray(plane_counts, dtype=np.int64)
        part = self.part
        n_pages = int(plane_counts.sum())
        if n_pages == 0 and n_blocks == 0:
            return ProgramResult()
        lat = part.rewrite_latency_us(
            n_pages, n_blocks, self.timing.t_ca,
            plane_counts=plane_counts if self.policy.plane_parallel
            else None)
        e_prog = part.e_page_prog
        assert e_prog is not None          # set by FlashPart.__post_init__
        energy = n_pages * (part.e_page_read + e_prog)
        self.reset_state()
        return ProgramResult(latency_us=lat, energy_uj=energy,
                             n_pages=n_pages, n_blocks=n_blocks,
                             bytes_programmed=n_pages * part.page_bytes)
