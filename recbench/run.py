"""Run one cell of ``BENCHMARK.json`` on this machine's CUDA card.

    python3 recbench/run.py --workload rmc2-bulk-k0 --seed 7 --seconds 20 \\
        --trace 0

Prints the run's result as the last line of standard output, one JSON
object, and the numbers its check compared as the last lines of standard
error. Exits with another code than 0, and prints no result, where there is
no card (or fewer than the cell asks for), where the checkout holds no
``src/repro_torch``, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache in the checkout, at fixed paths
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton_cache",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch under {ROOT}: nothing to measure",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from recbench import harness
    from recbench.spec import Benchmark

    chips = Benchmark(ROOT).cell(args.workload).chips
    harness.log(f"set-up: {time.perf_counter() - T_START:.3f} s to import "
                f"torch and the harness")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {n}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"JAX or the JAX package was loaded: {', '.join(foreign)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
