"""Time the flash attention kernel of one or more checkouts on the card.

    python tools/flash_bench.py ROOT [ROOT ...] [--reps N]
        [--dtype {bfloat16,float32}]

Each ROOT (a checkout, or a ``git archive`` of one) runs in a process of
its own, in the order given, so that each imports its own ``repro_torch``
and builds its own kernels: list two commits as ``parent change change
parent`` to compare them on one card. For each it times
``flash_attention_fwd`` and ``flash_attention_bwd`` (out and lse given) at
chip_smoke.py's attention shapes, by CUDA events over back-to-back calls
after a warm call, beside ``F.scaled_dot_product_attention`` (a yardstick
the port never calls) and the bound (2 FLOP a multiply-add over the causal
pairs at 989 TFLOP/s in bf16, 67 in float32 off the tensor cores), and the
nvcc seconds of its flash attention source. ``--dtype`` picks the inputs'
type and so the route: bf16 (the default) runs on wgmma, float32 on the
CUDA cores.
It prints one JSON line a run, then the card's name and power limit as
``nvidia-smi`` gives them. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# chip_smoke.py's ATTN_SHAPE, MLA_SHAPE, CP_SHAPE and LM100M_ATTN_SHAPE:
# qwen3-1.7b's prefill, deepseek-v3's MLA (v a split view), a
# context-parallel block of qwen2-0.5b and lm-100m's training; causal,
# q_start = S - T unless given
SHAPES = {
    "attn": dict(b=8, t=4096, h=16, kv=8, d=128),
    "mla": dict(b=2, t=4096, h=128, kv=128, d=192, dv=128, split_v=True),
    "cp": dict(b=8, t=1024, s=4096, h=14, kv=2, d=64, q_start=2048),
    "lm100m": dict(b=64, t=256, h=8, kv=4, d=64),
}
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def _flops(shape: dict) -> tuple[float, float]:
    """Forward and backward FLOPs over the causal (query, key) pairs."""
    b, t, h, d = shape["b"], shape["t"], shape["h"], shape["d"]
    s, dv = shape.get("s", t), shape.get("dv", d)
    q_start = shape.get("q_start", s - t)
    pairs = b * h * sum(min(max(q_start + i + 1, 0), s) for i in range(t))
    return 2.0 * pairs * (d + dv), 2.0 * pairs * (3 * d + 2 * dv)


def _ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_one(root: Path, reps: int, dtype_name: str) -> dict:
    """Time ``root``'s kernel at every shape in ``dtype_name`` (this
    process only)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        raise SystemExit("flash_bench: no CUDA card available")
    t0 = time.perf_counter()
    _build.build_all(("flash_attention",))
    dtype = getattr(torch, dtype_name)
    out = {"root": str(root), "build_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0), "dtype": dtype_name,
           "shapes": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape in SHAPES.items():
        b, t, h, kv, d = (shape[x] for x in ("b", "t", "h", "kv", "d"))
        s, dv = shape.get("s", t), shape.get("dv", d)

        def rnd(*size):
            return torch.randn(size, generator=gen, device="cuda",
                               dtype=dtype)

        q, k = rnd(b, t, h, d), rnd(b, s, kv, d)
        v = (rnd(b, s, kv, 128 + dv).split([128, dv], -1)[1]
             if shape.get("split_v") else rnd(b, s, kv, dv))
        dout = rnd(b, t, h, dv)
        args = (shape.get("q_start", s - t), True, min(512, t),
                min(1024, s), d ** -0.5)
        o, lse = fa.flash_attention_fwd(q, k, v, *args)
        rec = {
            "fwd_ms": _ms(lambda: fa.flash_attention_fwd(q, k, v, *args),
                          reps),
            "bwd_ms": _ms(lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, dout, *args), max(1, reps // 2)),
        }
        f_fwd, f_bwd = _flops(shape)
        rec["bound_fwd_ms"] = 1e3 * f_fwd / PEAK_FLOPS[dtype_name]
        rec["bound_bwd_ms"] = 1e3 * f_bwd / PEAK_FLOPS[dtype_name]
        if "q_start" not in shape:     # SDPA's causal mask is q_start 0
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]

            def sdpa(q_, k_, v_):
                return F.scaled_dot_product_attention(
                    q_.transpose(1, 2), k_.transpose(1, 2),
                    v_.transpose(1, 2), is_causal=True,
                    enable_gqa=h != kv).transpose(1, 2)

            with torch.no_grad():
                rec["sdpa_fwd_ms"] = _ms(lambda: sdpa(q, k, v), reps)
            lib_out = sdpa(*leaves)
            rec["sdpa_bwd_ms"] = _ms(lambda: torch.autograd.grad(
                lib_out, leaves, dout, retain_graph=True), max(1, reps // 2))
            del lib_out, leaves
        out["shapes"][name] = rec
        del q, k, v, dout, o, lse
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtype", choices=tuple(PEAK_FLOPS), default="bfloat16")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.roots[0].resolve(), args.reps,
                                 args.dtype)))
        return 0
    for root in args.roots:
        res = subprocess.run(
            [sys.executable, __file__, "--one", "--reps", str(args.reps),
             "--dtype", args.dtype, str(root)], capture_output=True,
            text=True, check=False)
        lines = res.stdout.strip().splitlines()
        if res.returncode or not lines:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode or 1
        print(lines[-1], flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()
    print(card.splitlines()[0] if card else "power.limit not measured")
    return 0


if __name__ == "__main__":
    sys.exit(main())
