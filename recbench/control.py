"""The check's two readings on the card, for setting a configuration's
limit: the control (the cell's model's reference with TF32 products, put
in the program's place) against the float32 reference, on samples drawn
as a run of the cell draws them.

    python3 recbench/control.py --workload rmc2-bulk-k0 --seeds 1,2,3

Prints one JSON line a seed: ``logit_err`` of the emulated TF32 control
(``tf32``, what the tests hold) and of the card's own TF32 mode
(``tf32-card``). The program's reading is a run's own (``run.py``'s
``check logit_err`` line). No program is built here: the reference
regenerates the rows it reads.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    from recbench import harness, synth
    from recbench.spec import Benchmark

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = Benchmark(ROOT).cell(args.workload)
    model, tr = cell.model, cell.traffic
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        weights = model.make_weights(seed, dev)
        dense, indices, _ = model.make_pool(tr, seed, dev)
        rng = np.random.default_rng(synth.derive(seed, "check"))
        if tr["mode"] == "bulk":
            pick = rng.choice(dense.shape[0], harness.CHECK_STEPS,
                              replace=False)
            d, i = dense[pick].flatten(0, 1), indices[pick].flatten(0, 1)
        else:
            pick = torch.as_tensor(rng.choice(
                dense.shape[0], harness.CHECK_REQUESTS, replace=True))
            d, i = dense[pick, 0], indices[pick, 0]
        with torch.inference_mode():
            want = model.reference_logits(weights, seed, d, i)
            out = {"workload": args.workload, "seed": seed,
                   "samples": int(want.numel())}
            for p in ("tf32", "tf32-card"):
                got = model.reference_logits(weights, seed, d, i, p)
                out[p] = harness.logit_err(model, weights, seed,
                                           [(d, i, got)])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
