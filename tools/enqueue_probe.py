"""Host time to enqueue a bulk cell's forwards, untraced, beside the card's
time to run them: whether the host or the card sets a closed loop's pace.

    python tools/enqueue_probe.py [ROOT ...] [--workload rmc2-bulk-k0]
                                  [--seed N] [--forwards 20] [--rounds 10]
                                  [--out FILE]

Each ROOT (a checkout, or a ``git archive`` of one; default this one; a
root named twice runs twice) is measured in a process of its own that
imports that root's ``recbench`` and ``src``: the cell set up as
``recbench.harness`` sets it up (``prepare``, ``Bulk``, its warm-up), then
in each round: synchronise, enqueue ``--forwards`` forwards back to back
over the cell's pool entries in turn (``Bulk.step``, as ``Bulk.drive``
runs them), read the host clock (the enqueue), synchronise, read it again
(the card's time for the same forwards, from the same start). No profiler
is on. At 20 forwards of ~15 launches the queue holds every launch, so the
enqueue does not wait on the card. One JSON line a root: the medians a
forward of both, each round's, and the card's name and power limit. Needs
a CUDA card (about 20 s a root, most of it the cell's set-up).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(root: Path, workload: str, seed: int, forwards: int,
            rounds: int) -> dict:
    """The record of the module docstring for ``root``, in this process."""
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    from recbench import harness
    from recbench.spec import Benchmark

    if not torch.cuda.is_available():
        raise SystemExit("enqueue_probe: no CUDA card available")
    dev = torch.device("cuda")
    cell = Benchmark(root).cell(workload)
    if cell.traffic["mode"] != "bulk":
        raise SystemExit(f"{workload} is not a bulk cell")
    cfg, _, dense, indices, run = harness.prepare(cell, seed, dev)
    enqueue, total = [], []
    with torch.inference_mode():
        bulk = harness.Bulk(run, cfg, dense, indices)
        bulk.warm_up()
        n = dense.shape[0]
        for k in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(forwards):
                bulk.step((k * forwards + i) % n)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            enqueue.append(1e3 * (t1 - t0) / forwards)
            total.append(1e3 * (t2 - t0) / forwards)
    return {"root": str(root), "workload": workload, "seed": seed,
            "forwards": forwards, "rows": int(dense.shape[1]),
            "enqueue_ms": statistics.median(enqueue),
            "device_bound_ms": statistics.median(total),
            "enqueue_ms_rounds": enqueue, "device_bound_ms_rounds": total,
            "device": torch.cuda.get_device_name(dev)}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    return out.splitlines()[0] if out else "power.limit not measured"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", type=Path, default=[ROOT])
    ap.add_argument("--workload", default="rmc2-bulk-k0")
    ap.add_argument("--seed", type=int, default=2_718_281_828)
    ap.add_argument("--forwards", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--one", action="store_true",
                    help="measure the one ROOT in this process")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure(args.roots[0].resolve(), args.workload,
                                 args.seed, args.forwards, args.rounds)))
        return 0
    card = card_line()
    lines = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, __file__, str(root.resolve()), "--one",
             "--workload", args.workload, "--seed", str(args.seed),
             "--forwards", str(args.forwards), "--rounds",
             str(args.rounds)], capture_output=True, text=True, check=False)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        lines.append(json.dumps({**rec, "card": card}))
        print(lines[-1], flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
