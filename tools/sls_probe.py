"""Where the grouped SLS serves its rows from, and how far it stands from
its bound: the kernel of one or more checkouts timed on the card at rmc2's
shape, on ids whose ranks put every lookup in one level of the cache.

    python tools/sls_probe.py [ROOT ...] [--rounds N] [--out FILE]

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

Each ROOT (a checkout, or a ``git archive`` of one; default this one) has
its ``src/repro_torch/kernels/csrc/recflash_sls.cu`` built with this
checkout's ``nvcc`` flags into ``build/sls_probe/`` and called through its
C launcher (``recflash_sls_launch``, whose arguments every checkout since
the ragged layout shares) on the same tensors. Each round times every case
for every root, in the order given and then reversed (ABBA), by CUDA
events over 20 back-to-back launches after a warm one. Every
root's bags must equal the first root's bit for bit.

One JSON line a (root, case): the median ms a launch over the rounds and
each round's, the bound (the larger of the unique rows, ``rank_of``
entries, ids and bags at 3.35 TB/s and the adds at 67 TFLOP/s) and the
share of it reached, and the rate at which the launch copies rows (120
rows of 256 B a bag, whatever level serves them). The card's name and
power limit last. Needs a CUDA card and ``nvcc`` (about a minute).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

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
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
REPS = 20


def zipf_cdf(rows: int, alpha: float, device) -> torch.Tensor:
    """The float64 CDF of Zipf(``alpha``) over ranks 0..rows-1."""
    w = torch.arange(1, rows + 1, dtype=torch.float64,
                     device=device).pow_(-alpha)
    cdf = torch.cumsum(w, 0)
    return cdf.div_(cdf[-1].clone())


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
        u = torch.rand(batch * lookups, generator=gen, device=dev,
                       dtype=torch.float64)
        cdf = zipf_cdf(rows, ALPHAS[case], dev)
        return torch.searchsorted(cdf, u, right=True).clamp_(
            max=rows - 1).view(shape)
    raise ValueError(f"unknown case {case!r}; cases: {', '.join(CASES)}")


def bound(ranks: list[torch.Tensor], ids: torch.Tensor, dim: int,
          esize: int) -> tuple[float, str]:
    """The least ms of one launch over (B, n_tables, L) ``ids`` whose
    ranks, a table each, are ``ranks``: each unique row and ``rank_of``
    entry read once, the ids read and the bags written once, at 3.35 TB/s;
    the adds at 67 TFLOP/s. Returns (ms, what bounds it)."""
    b, n_t, lk = ids.shape
    uniq = sum(int(torch.unique(r).numel()) for r in ranks)
    n_bytes = (uniq * (dim * esize + 4) + ids.numel() * 4
               + b * n_t * dim * esize)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = b * n_t * lk * dim / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "adds"


def build(roots: list[Path]) -> dict[Path, ctypes._CFuncPtr]:
    """Each root's SLS source built (one ``nvcc`` a distinct source, all at
    once) and its launcher bound."""
    BUILD.mkdir(parents=True, exist_ok=True)
    flags = _build.flags("recflash_sls")
    libs, running = {}, []
    for root in roots:
        src = root / SOURCE
        if src.resolve() == (_build.CSRC / "recflash_sls.cu").resolve():
            _build.build_all(("recflash_sls",))    # this checkout's own
            libs[root] = _build.library_path("recflash_sls")
            continue
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(flags).encode()).hexdigest()
        lib = BUILD / f"recflash_sls-{digest[:16]}.so"
        if not lib.exists() and all(p[1] != lib for p in running):
            running.append((subprocess.Popen(
                [_build.nvcc(), *flags, "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                lib))
        libs[root] = lib
    for proc, lib in running:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
    fns = {}
    for root, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).recflash_sls_launch
        fn.argtypes, fn.restype = sls._ARGTYPES, ctypes.c_int
        fns[root] = fn
    return fns


def launcher(fn, desc: sls.TableDescs, ids: torch.Tensor, out: torch.Tensor):
    """One grouped launch of ``fn`` on the current stream, as
    ``recflash_sls_grouped`` makes it for uniform bags."""
    b, n_t, lk = ids.shape
    args = (desc.tensor.data_ptr(), 0, 0, 0, 0, ids.data_ptr(),
            *ids.stride(), out.data_ptr(), b, n_t, lk, out.shape[2],
            _build.DTYPE_CODES[out.dtype], int(desc.vec), None)

    def go():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"recflash_sls launch failed: CUDA error {err}")
    return go


def time_ms(go) -> float:
    go()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        go()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def probe(roots: list[Path], rounds: int = 3) -> list[dict]:
    """The records of the module docstring, one a (root, case)."""
    if not torch.cuda.is_available():
        raise SystemExit("sls_probe: no CUDA card available")
    fns = build(roots)
    gen = torch.Generator(device="cuda").manual_seed(0)
    perms = [torch.randperm(ROWS, generator=gen, device="cuda")
             for _ in range(TABLES)]
    rank_of = [p.argsort().to(torch.int32) for p in perms]
    tables = [torch.randn(ROWS, DIM, generator=gen, device="cuda")
              for _ in range(TABLES)]
    hot = (HOT,) * TABLES
    desc = sls.describe(tables, hot, rank_of)
    records = []
    for case in CASES:
        ranks = [case_ranks(case, BATCH, LOOKUPS, ROWS, HOT, gen)
                 for _ in range(TABLES)]
        ids = torch.stack([p[r] for p, r in zip(perms, ranks, strict=True)],
                          dim=1).to(torch.int32)
        bound_ms, bound_by = bound(ranks, ids, DIM, 4)
        del ranks
        outs = {r: torch.empty(BATCH, TABLES, DIM, device="cuda")
                for r in roots}
        gos = {r: launcher(fns[r], desc, ids, outs[r]) for r in roots}
        times: dict[Path, list[float]] = {r: [] for r in roots}
        for k in range(rounds):
            for r in (roots if k % 2 == 0 else roots[::-1]):
                times[r].append(time_ms(gos[r]))
        for r in roots:
            if not torch.equal(outs[r], outs[roots[0]]):
                raise AssertionError(f"{case}: {r}'s bags differ from "
                                     f"{roots[0]}'s")
            ms = statistics.median(times[r])
            records.append({
                "root": str(r), "case": case, "ms": ms, "ms_rounds": times[r],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "roofline_pct": 100.0 * bound_ms / ms,
                "row_copies_tb_s": BATCH * TABLES * LOOKUPS * DIM * 4
                / (ms * 1e-3) / 1e12})
        del ids, outs, gos
    return records


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    return out.splitlines()[0] if out else "power.limit not measured"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path, default=[ROOT])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    roots = list(dict.fromkeys(r.resolve() for r in args.roots))
    records = probe(roots, args.rounds)
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
