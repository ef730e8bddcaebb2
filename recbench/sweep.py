"""Find the highest rate an online cell sustains: one set-up, then the
cell's open loop at each rate in turn, on the card.

    python3 recbench/sweep.py --workload rmc2-online-k0 --seed 5 \\
        --seconds 4 --rates 20000,40000,60000

Prints one JSON line a rate: requests due, batches and their mean size,
p50 / p95 / p99 latency, and the backlog: how far the last tenth of the
window's requests waited beyond the first tenth's (a queue that grows all
through the window). A rate is sustained where the backlog stays near 0.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--rates", required=True,
                    help="comma-separated requests a second")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    from recbench import harness
    from recbench.arith import percentiles
    from recbench.spec import Benchmark

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = Benchmark(ROOT).cell(args.workload)
    dev = torch.device("cuda")
    cfg, _, dense, indices, run = harness.prepare(cell, args.seed, dev)
    with torch.inference_mode():
        for rate in (float(r) for r in args.rates.split(",")):
            tr = {**cell.traffic, "rate_rps": rate}
            drv = harness.Online(run, cfg, tr, dense, indices, args.seconds,
                                 dev)
            drv.warm_up()
            wall, steps, _, first, due = drv.drive(args.seconds, 0.0, None)
            lat = 1e3 * (drv.done[first:due] - drv.sched[first:due])
            tenth = max(1, lat.size // 10)
            p50, p95, p99 = percentiles(lat)
            print(json.dumps({
                "rate_rps": rate, "due": int(due - first), "batches": steps,
                "mean_batch": (due - first) / max(steps, 1),
                "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
                "backlog_ms": float(np.nanmedian(lat[-tenth:])
                                    - np.nanmedian(lat[:tenth])),
                "unanswered": int(np.isnan(lat).sum()), "wall_s": wall}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
