"""Where the grouped SLS serves its rows from, and how far it stands from
its bound: the kernel of one or more checkouts timed on the card at rmc2's
shape, on ids whose ranks put every lookup in one level of the cache.

    python tools/sls_probe.py [ROOT ...] [--rounds N] [--cases C,...]
                              [--out FILE]

rmc2 (the RecFlash paper's RMC2, ``recbench/configs/rmc2.json``): 32 f32
tables of 1M x 64 stored in rank order, 2000 hot rows each, ``rank_of`` a
random permutation, batch 4096, 120 lookups a table. The cases, by the
ranks a table's ids translate to (``case_ranks``):

* ``one``: every lookup reads rank 0, one row a table (the least a gather
  can read from L2, or from L1 where a hot copy allocates there);
* ``head64``: ranks uniform over the first 64, 16 KB a table;
* ``cold``: all-distinct cold ranks, 491,520 a table (every row from HBM);
* ``zipf-k0``, ``zipf-k2``: Zipf ranks at ``bulk-k0``'s and ``bulk-k2``'s
  exponents (1.2332, 0.5860), the benchmark cells' traffic.

Two more cases run on the 16-byte path's other users: Criteo 1TB's 26
tables as DLRM-DCNv2 caps them (``configs/dlrm_dcnv2.py``; 204M rows, 52.3
GB of bf16 at D=128), ``rank_of`` as the benchmark's remap builds it from a
profile of 2^20 draws (``profile_rank_of``; hot sizes the default 0.2%),
Zipf ids at Criteo 1TB's exponent (1.1), batch 65,536:

* ``criteo-l1``: one id a table (dlrm-mlperf's one-hot bags);
* ``criteo-ragged``: DLRM-DCNv2's bags of 1 to 100 ids (214 a sample), one
  ragged launch.

Each Criteo launch is timed alone after 128 MB are written, so it finds L2
cold, as it does in those cells; the rmc2 launches run back to back, as
rmc2's small steps leave L2 warm between them.

Each ROOT (a checkout, or a ``git archive`` of one; default this one) has
its ``src/repro_torch/kernels/csrc/recflash_sls.cu`` built with this
checkout's ``nvcc`` flags (``-Xptxas -v`` among them) into
``build/sls_probe/`` and called through its C launcher
(``recflash_sls_launch``, whose arguments every checkout since the ragged
layout shares) on the same tensors. Each round times every case for every
root, in the order given and then reversed (ABBA), by CUDA events over 20
launches after a warm one (``time_ms``). Every root's bags must equal the
first root's bit for bit.

First one JSON line a root: ptxas's report of each ``sls_kernel``
instance (registers a thread, static shared memory a block, stack and
spills; the ranks' shared memory is dynamic, sized at launch). Then one a
(root, case): the median ms a launch over the rounds and each round's, the
bound (the larger of the unique rows, ``rank_of`` entries, ids and bags at
3.35 TB/s and the adds at 67 TFLOP/s) and the share of it reached, and the
rate at which the launch reads rows (120 rows of 256 B a bag, whatever
level serves them). Then, where Nsight Compute (``ncu``) is on the
machine, one line with its L1 hit rate and shared-memory wavefronts of
each root's ``zipf-k0`` launch (or why there are none). The card's name
and power limit last. Needs a CUDA card and ``nvcc`` (about a minute).
"""

from __future__ import annotations

import argparse
import csv
import ctypes
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import dlrm_dcnv2  # noqa: E402
from repro_torch.data.criteo import CRITEO_TB  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import recflash_sls as sls  # noqa: E402

SOURCE = Path("src/repro_torch/kernels/csrc/recflash_sls.cu")
BUILD = ROOT / "build" / "sls_probe"
# rmc2 at its published size; RemapSpec.from_counts's default hot share
TABLES, ROWS, DIM, HOT = 32, 1_000_000, 64, 2000
BATCH, LOOKUPS = 4096, 120
HEAD = 64
# bulk-k0's and bulk-k2's Zipf exponents (recbench/traffic/*.json)
ALPHAS = {"zipf-k0": 1.2331799856069665, "zipf-k2": 0.5860024073504064}
CASES = ("one", "head64", "cold", *ALPHAS)
# Criteo 1TB's 26 tables as MLPerf's DLRM-DCNv2 caps them (52.3 GB of bf16
# at D=128, as the benchmark stores them), ranked as the benchmark's remap
# ranks them (by counts over a profile of 2^20 draws, ties by id; hot sizes
# the remap's default share), Zipf ids at Criteo 1TB's exponent, batch
# 65,536: one id a table (dlrm-mlperf's one-hot bags) or DCNv2's bag
# lengths (1 to 100, ragged)
CRITEO_DIM, CRITEO_BATCH, HOT_SHARE, PROFILE = 128, 65536, 0.002, 1 << 20
# written before each timed Criteo launch: more than the 50 MB L2 holds, as
# the GB of activations of those cells' steps between two SLS launches
FLUSH_BYTES = 128 << 20
CRITEO_CASES = {"criteo-l1": (1,) * len(dlrm_dcnv2.VOCABS),
                "criteo-ragged": dlrm_dcnv2.BAG_LENGTHS}
ALL_CASES = (*CASES, *CRITEO_CASES)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
REPS = 20
# Nsight Compute's counters of a launch's L1 traffic
NCU_METRICS = ("l1tex__t_sector_hit_rate.pct",
               "l1tex__data_pipe_lsu_wavefronts_mem_shared.sum")


def zipf_cdf(rows: int, alpha: float, device) -> torch.Tensor:
    """The float64 CDF of Zipf(``alpha``) over ranks 0..rows-1."""
    w = torch.arange(1, rows + 1, dtype=torch.float64,
                     device=device).pow_(-alpha)
    cdf = torch.cumsum(w, 0)
    return cdf.div_(cdf[-1].clone())


def zipf_ranks(batch: int, lookups: int, rows: int, alpha: float,
               gen: torch.Generator) -> torch.Tensor:
    """(batch, lookups) int64 Zipf(``alpha``) ranks of a table of ``rows``,
    drawn from ``gen`` on its device."""
    u = torch.rand(batch * lookups, generator=gen, device=gen.device,
                   dtype=torch.float64)
    cdf = zipf_cdf(rows, alpha, gen.device)
    return torch.searchsorted(cdf, u, right=True).clamp_(
        max=rows - 1).view(batch, lookups)


def profile_rank_of(perm: torch.Tensor, draws: int, alpha: float,
                    gen: torch.Generator) -> torch.Tensor:
    """The int32 ``rank_of`` the benchmark's remap builds for a table whose
    id of popularity rank r is ``perm[r]``: ids counted over ``draws``
    Zipf(``alpha``) draws, ranked by count, ties by id
    (``RemapSpec.from_counts``)."""
    rows = perm.numel()
    ids = perm[zipf_ranks(draws, 1, rows, alpha, gen).view(-1)]
    counts = torch.bincount(ids, minlength=rows)
    order = torch.sort(-counts, stable=True).indices
    rank_of = torch.empty(rows, dtype=torch.int32, device=perm.device)
    rank_of[order] = torch.arange(rows, dtype=torch.int32, device=perm.device)
    return rank_of


def case_ranks(case: str, batch: int, lookups: int, rows: int, hot: int,
               gen: torch.Generator) -> torch.Tensor:
    """One table's (batch, lookups) int64 ranks of ``case`` (module
    docstring), drawn from ``gen`` on its device."""
    dev, shape = gen.device, (batch, lookups)
    if case == "one":
        return torch.zeros(shape, dtype=torch.int64, device=dev)
    if case == "head64":
        return torch.randint(0, min(HEAD, rows), shape, generator=gen,
                             device=dev)
    if case == "cold":
        n = batch * lookups
        if n > rows - hot:
            raise ValueError(f"{n} distinct cold ranks need {n + hot} rows, "
                             f"not {rows}")
        return (torch.randperm(rows - hot, generator=gen, device=dev)[:n]
                + hot).view(shape)
    if case in ALPHAS:
        return zipf_ranks(batch, lookups, rows, ALPHAS[case], gen)
    raise ValueError(f"unknown case {case!r}; cases: {', '.join(CASES)}")


def bound(ranks: list[torch.Tensor], ids: torch.Tensor, dim: int,
          esize: int) -> tuple[float, str]:
    """The least ms of one launch over ``ids`` ((B, n_tables, L), or (B,
    sum of the bag lengths) for ragged bags) whose ranks, a table each, are
    ``ranks``: each unique row and ``rank_of`` entry read once, the ids
    read and the bags written once, at 3.35 TB/s; the adds at 67 TFLOP/s.
    Returns (ms, what bounds it)."""
    uniq = sum(int(torch.unique(r).numel()) for r in ranks)
    n_bytes = (uniq * (dim * esize + 4) + ids.numel() * 4
               + ids.shape[0] * len(ranks) * dim * esize)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ids.numel() * dim / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "adds"


def ptxas_report(log: str) -> list[dict]:
    """The ``sls_kernel`` instances of an ``nvcc -Xptxas -v`` log: each
    one's registers a thread, static shared memory a block (bytes), stack
    frame and spills (bytes), in the order compiled."""
    kernels: dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$.]+)'?", line)
        if m:
            cur = kernels.setdefault(m.group(1), {
                "kernel": m.group(1), "registers": None, "smem_bytes": 0,
                "stack_bytes": 0, "spill_stores": 0, "spill_loads": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = (
                int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    return [k for k in kernels.values() if "sls_kernel" in k["kernel"]]


def demangle(names: list[str]) -> list[str]:
    """``names`` through ``c++filt`` where the machine has it."""
    if not names or shutil.which("c++filt") is None:
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True, check=False).stdout
    lines = out.splitlines()
    return lines if len(lines) == len(names) else names


def build(roots: list[Path]) -> tuple[dict[Path, ctypes._CFuncPtr],
                                      dict[Path, str]]:
    """Each root's SLS source built (one ``nvcc`` a distinct source, all at
    once; the compiler's log kept beside the library) and its launcher
    bound. Returns the launchers and each root's ``nvcc`` log."""
    BUILD.mkdir(parents=True, exist_ok=True)
    flags = _build.flags("recflash_sls")
    libs, running = {}, []
    for root in roots:
        src = root / SOURCE
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(flags).encode()).hexdigest()
        lib = BUILD / f"recflash_sls-{digest[:16]}.so"
        if not lib.exists() and all(p[1] != lib for p in running):
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            running.append((subprocess.Popen(
                [_build.nvcc(), *flags, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                lib, tmp))
        libs[root] = lib
    for proc, lib, tmp in running:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    fns, logs = {}, {}
    for root, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).recflash_sls_launch
        fn.argtypes, fn.restype = sls._ARGTYPES, ctypes.c_int
        fns[root] = fn
        logs[root] = lib.with_suffix(".log").read_text()
    return fns, logs


def launcher(fn, desc: sls.TableDescs, ids: torch.Tensor, out: torch.Tensor,
             lookups: tuple[int, ...] | None = None):
    """One grouped launch of ``fn`` on the current stream, as
    ``recflash_sls_grouped`` makes it: uniform bags, or ragged ones of
    ``lookups`` ids a table."""
    if lookups is None:
        (b, n_t, lk), strides, ragged = ids.shape, ids.stride(), None
    else:
        b, n_t, lk = ids.shape[0], len(lookups), max(lookups)
        strides = (ids.stride(0), 0, ids.stride(1))
        ragged = ctypes.addressof(sls._ragged_arg(tuple(lookups)))
    args = (desc.tensor.data_ptr(), 0, 0, 0, 0, ids.data_ptr(), *strides,
            out.data_ptr(), b, n_t, lk, out.shape[2],
            _build.DTYPE_CODES[out.dtype], int(desc.vec), ragged)

    def go():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"recflash_sls launch failed: CUDA error {err}")
    return go


def time_ms(go, flush: torch.Tensor | None = None) -> float:
    """ms a launch of ``go`` over REPS launches after a warm one: back to
    back, or each after ``flush`` is overwritten (L2 cold, as a cell
    whose step streams more than L2 holds between two SLS launches finds
    it) and timed alone."""
    go()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * REPS)]
    if flush is None:
        ev[0].record()
        for _ in range(REPS):
            go()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / REPS
    for k in range(REPS):
        flush.fill_(k)
        ev[2 * k].record()
        go()
        ev[2 * k + 1].record()
    torch.cuda.synchronize()
    return sum(ev[2 * k].elapsed_time(ev[2 * k + 1])
               for k in range(REPS)) / REPS


def compare(roots: list[Path], fns: dict, desc: sls.TableDescs,
            case: str, ranks: list[torch.Tensor], ids: torch.Tensor,
            out_shape: tuple, dtype: torch.dtype, rounds: int,
            lookups: tuple[int, ...] | None = None,
            flush: torch.Tensor | None = None) -> list[dict]:
    """Every root's launch over ``ids`` timed in turns (ABBA), its bags held
    to the first root's bit for bit: one record a root."""
    dim = out_shape[-1]
    bound_ms, bound_by = bound(ranks, ids, dim, dtype.itemsize)
    outs = {r: torch.empty(out_shape, dtype=dtype, device="cuda")
            for r in roots}
    gos = {r: launcher(fns[r], desc, ids, outs[r], lookups) for r in roots}
    times: dict[Path, list[float]] = {r: [] for r in roots}
    for k in range(rounds):
        for r in (roots if k % 2 == 0 else roots[::-1]):
            times[r].append(time_ms(gos[r], flush))
    records = []
    for r in roots:
        if not torch.equal(outs[r], outs[roots[0]]):
            raise AssertionError(f"{case}: {r}'s bags differ from "
                                 f"{roots[0]}'s")
        ms = statistics.median(times[r])
        records.append({
            "root": str(r), "case": case, "ms": ms, "ms_rounds": times[r],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "roofline_pct": 100.0 * bound_ms / ms,
            "row_copies_tb_s": ids.numel() * dim * dtype.itemsize
            / (ms * 1e-3) / 1e12})
    return records


def rmc2_records(roots, fns, cases, rounds, gen) -> list[dict]:
    """The rmc2 cases (module docstring) of ``cases``."""
    perms = [torch.randperm(ROWS, generator=gen, device="cuda")
             for _ in range(TABLES)]
    rank_of = [p.argsort().to(torch.int32) for p in perms]
    tables = [torch.randn(ROWS, DIM, generator=gen, device="cuda")
              for _ in range(TABLES)]
    desc = sls.describe(tables, (HOT,) * TABLES, rank_of)
    records = []
    for case in cases:
        ranks = [case_ranks(case, BATCH, LOOKUPS, ROWS, HOT, gen)
                 for _ in range(TABLES)]
        ids = torch.stack([p[r] for p, r in zip(perms, ranks, strict=True)],
                          dim=1).to(torch.int32)
        records += compare(roots, fns, desc, case, ranks, ids,
                           (BATCH, TABLES, DIM), torch.float32, rounds)
    return records


def criteo_records(roots, fns, cases, rounds, gen) -> list[dict]:
    """The Criteo cases (``CRITEO_CASES``) of ``cases``."""
    vocabs = dlrm_dcnv2.VOCABS
    perms = [torch.randperm(v, generator=gen, device="cuda") for v in vocabs]
    rank_of = [profile_rank_of(p, PROFILE, CRITEO_TB.zipf_alpha, gen)
               for p in perms]
    tables = [torch.empty(v, CRITEO_DIM, dtype=torch.bfloat16,
                          device="cuda").normal_(generator=gen)
              for v in vocabs]
    hot = [max(1, round(v * HOT_SHARE)) for v in vocabs]
    desc = sls.describe(tables, hot, rank_of)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    records = []
    for case in cases:
        lookups = CRITEO_CASES[case]
        ranks = [zipf_ranks(CRITEO_BATCH, n, v, CRITEO_TB.zipf_alpha, gen)
                 for v, n in zip(vocabs, lookups, strict=True)]
        ids = torch.cat([p[r] for p, r in zip(perms, ranks, strict=True)],
                        dim=1).to(torch.int32)
        records += compare(roots, fns, desc, case, ranks, ids,
                           (CRITEO_BATCH, len(vocabs), CRITEO_DIM),
                           torch.bfloat16, rounds, lookups, flush)
    return records


def probe(roots: list[Path], rounds: int = 3,
          cases: tuple[str, ...] = ALL_CASES) -> list[dict]:
    """The records of the module docstring: one a root (ptxas), then one a
    (root, case)."""
    if not torch.cuda.is_available():
        raise SystemExit("sls_probe: no CUDA card available")
    unknown = set(cases) - set(ALL_CASES)
    if unknown:
        raise ValueError(f"unknown cases {sorted(unknown)}; cases: "
                         f"{', '.join(ALL_CASES)}")
    fns, logs = build(roots)
    records = []
    for r in roots:
        rep = ptxas_report(logs[r])
        for k, name in zip(rep, demangle([k["kernel"] for k in rep]),
                           strict=True):
            k["kernel"] = name
        records.append({"root": str(r), "ptxas": rep})
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, of in ((rmc2_records, CASES), (criteo_records, CRITEO_CASES)):
        mine = [c for c in cases if c in of]
        if mine:
            records += shape(roots, fns, mine, rounds, gen)
            torch.cuda.empty_cache()
    return records


def ncu_medians(csv_text: str, roots: list[Path]) -> dict[str, dict]:
    """Each root's median of each ``NCU_METRICS`` counter, from ``ncu
    --csv``'s rows of the one-round ``zipf-k0`` run: REPS + 1 launches a
    root (the warm one, then the timed ones), the roots in the order
    given."""
    rows = [r for r in csv.DictReader(
        line for line in csv_text.splitlines() if line.startswith('"'))
        if r.get("Metric Name") in NCU_METRICS]
    ids = sorted({int(r["ID"]) for r in rows})
    per_root = len(ids) // max(len(roots), 1)
    out: dict[str, dict] = {str(root): {} for root in roots}
    for k, root in enumerate(roots):
        mine = set(ids[k * per_root:(k + 1) * per_root])
        for m in NCU_METRICS:
            vals = [float(r["Metric Value"].replace(",", "")) for r in rows
                    if r["Metric Name"] == m and int(r["ID"]) in mine]
            if vals:
                out[str(root)][m] = statistics.median(vals)
    return out


def ncu_record(roots: list[Path]) -> dict:
    """Nsight Compute's ``NCU_METRICS`` of each root's ``zipf-k0`` launch:
    this probe run again under ``ncu`` on that case alone, one round. Where
    the machine has no ``ncu``, or it fails, the record says so."""
    ncu = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    if not Path(ncu).is_file():
        return {"ncu": "not on this machine"}
    cmd = [ncu, "--metrics", ",".join(NCU_METRICS), "--csv",
           "--kernel-name", "regex:sls_kernel", sys.executable, __file__,
           *map(str, roots), "--rounds", "1", "--cases", "zipf-k0"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=1200, check=False)
    except subprocess.TimeoutExpired:
        return {"ncu": "timed out"}
    if proc.returncode:
        return {"ncu": f"exit {proc.returncode}",
                "tail": (proc.stdout + proc.stderr)[-2000:]}
    return {"ncu": "ok", "case": "zipf-k0",
            "medians": ncu_medians(proc.stdout, roots)}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    return out.splitlines()[0] if out else "power.limit not measured"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path, default=[ROOT])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cases", default=",".join(ALL_CASES))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    roots = list(dict.fromkeys(r.resolve() for r in args.roots))
    cases = tuple(args.cases.split(","))
    records = probe(roots, args.rounds, cases)
    if "zipf-k0" in cases and cases != ("zipf-k0",):
        records.append(ncu_record(roots))
    card = card_line()
    lines = [json.dumps({**rec, "card": card}) for rec in records]
    print("\n".join(lines))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
