"""Host and device time of the DLRM forward's two routes, on the card.

For rmc2 (the RecFlash paper's RMC2 at full size: 32 f32 tables of 1M x 64,
120 lookups) and dlrm-mlperf (its widths and MLPs in float32, bf16 tables
each cut to at most 1M rows: the one-hot SLS reads one row a field either
way), at each batch size, in turns eager, graph, graph, eager:

* ``dispatch_ms``: the host's wall time of one forward call, the card's
  queue drained before it (the eager route: ``models.dlrm._eager``; the
  graph route: ``dlrm.forward``, copies into the static inputs, replay and
  the output's clone);
* ``device_ms``: the card's time of one forward, by CUDA events over calls
  queued behind a spin kernel, so that host issue does not enter it;
* ``step_ms``: one online step as ``recbench``'s online harness takes it:
  the batch copied in from pinned host memory, the forward, the logits back
  on the host (mean and median).

The graph route's limit (``dlrm.GRAPH_MAX_ROWS``) is raised in this
process only, so that the sizes above it show what a graph would give
there. Ids are skewed towards the hot rows (rank = V * u^4, ``rank_of``
the identity, hot size V / 100). One JSON line per (config, rows); run on
the card from the repo root:

    python tools/dlrm_graph_probe.py --out build/graph_probe.jsonl
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import dlrm_mlperf  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402

ROWS = (1, 16, 64, 256, 512, 1024, 2048)
MAX_TABLE_ROWS = 1_000_000
QUEUED = 24            # forwards queued behind one spin (~19 launches each)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power.limit not measured"


def build(name: str):
    if name == "rmc2":
        cfg, table_dtype = dlrm.RMC2, torch.float32
    else:
        full = dlrm_mlperf.CONFIG
        cfg = dlrm.DLRMConfig(
            name=full.name, n_tables=full.n_tables, n_dense=full.n_dense,
            embed_dim=full.embed_dim,
            n_rows=tuple(min(v, MAX_TABLE_ROWS) for v in full.n_rows),
            lookups=full.lookups, bot_mlp=full.bot_mlp,
            top_mlp=full.top_mlp)
        table_dtype = torch.bfloat16
    params = dlrm.init(0, cfg, device="cuda")
    params["tables"] = [t.to(table_dtype) for t in params["tables"]]
    params = dlrm.add_remap(
        params, [torch.arange(v, dtype=torch.int32) for v in cfg.n_rows],
        [max(1, v // 100) for v in cfg.n_rows])
    return cfg, params


def host_batch(cfg, rows: int, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand(rows, cfg.n_tables, cfg.lookups, generator=gen)
    vocab = torch.tensor(cfg.n_rows, dtype=torch.float64)[None, :, None]
    ids = (vocab * u.double() ** 4).long().clamp_max(vocab.long() - 1)
    return {"dense": torch.randn(rows, cfg.n_dense,
                                 generator=gen).pin_memory(),
            "indices": ids.to(torch.int32).pin_memory()}


def on_card(batch: dict) -> dict:
    return {k: v.to("cuda", non_blocking=True) for k, v in batch.items()}


def dispatch_ms(fn, batch: dict, n: int) -> float:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(batch)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times)


def device_ms(fn, batch: dict, issue_ms: float) -> float:
    spin_s = max(0.02, 3e-3 * issue_ms * QUEUED)
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * 2e9))       # cycles at ~2 GHz
        start.record()
        for _ in range(QUEUED):
            fn(batch)
        end.record()
        early = start.query()          # the card reached the calls early
        torch.cuda.synchronize()
        if not early:
            return start.elapsed_time(end) / QUEUED
        spin_s *= 4
    raise RuntimeError("host issue outlasted every spin: not measured")


def step_ms(fn, host: dict, n: int) -> tuple[float, float]:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(on_card(host)).float().cpu().numpy()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.fmean(times), 1e3 * statistics.median(times)


def measure(cfg, params, rows: int, steps: int) -> dict:
    host = host_batch(cfg, rows, rows)
    batch = on_card(host)

    def eager(b):
        return dlrm._eager(params, b, cfg, None, None, False, False, False)

    def graph(b):
        return dlrm.forward(params, b, cfg)

    routes = {"eager": eager, "graph": graph}
    for fn in routes.values():        # load, warm cuBLAS, capture
        fn(batch)
        fn(batch)
    torch.cuda.synchronize()
    want = eager(batch)
    got = graph(batch)
    err = float((got - want).abs().max())
    res = {name: {"dispatch_ms": [], "device_ms": [], "step_ms": [],
                  "step_median_ms": []} for name in routes}
    for name in ("eager", "graph", "graph", "eager"):
        fn, r = routes[name], res[name]
        d = dispatch_ms(fn, batch, steps)
        r["dispatch_ms"].append(d)
        r["device_ms"].append(device_ms(fn, batch, d))
        mean, median = step_ms(fn, host, steps)
        r["step_ms"].append(mean)
        r["step_median_ms"].append(median)
    return {"rows": rows, "max_abs_diff": err,
            **{name: {k: statistics.fmean(v) for k, v in r.items()}
               for name, r in res.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="rmc2,dlrm-mlperf")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dlrm.GRAPH_MAX_ROWS = max(dlrm.GRAPH_MAX_ROWS,
                              *map(int, args.rows.split(",")))
    card = card_line()
    out = open(args.out, "a") if args.out else None
    try:
        for name in args.configs.split(","):
            cfg, params = build(name)
            with torch.inference_mode():
                for rows in map(int, args.rows.split(",")):
                    line = json.dumps({"config": name, "card": card,
                                       **measure(cfg, params, rows,
                                                 args.steps)})
                    print(line, flush=True)
                    if out:
                        out.write(line + "\n")
            del params
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
