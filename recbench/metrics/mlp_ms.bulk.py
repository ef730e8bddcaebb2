"""mlp_ms.bulk: device milliseconds per step in the MLPs' matrix products
(cuBLAS's GEMM and GEMV kernels and their split-K reductions) in the traced
window. The kernels counted are named on standard error."""

import sys

KEYS = ("gemm", "gemv", "cutlass", "xmma", "splitkreduce")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in KEYS)


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    names = sorted({n for n in t.names if is_gemm(n)})
    if not names:
        return None
    for n in names:
        print(f"[recbench] mlp_ms.bulk counts {n}", file=sys.stderr)
    return 1e3 * t.seconds(is_gemm) / t.steps
