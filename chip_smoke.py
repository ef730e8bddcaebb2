#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Phases, each of which fails the run when it fails:

1. build: ``nvcc`` compiles both kernels from ``src/repro_torch/kernels/csrc``
   for sm_90a, one process per source, all at once;
2. check: each kernel against its plain PyTorch version on the card, at the
   dlrm-rm2 serving shapes (f32 and bf16, all-hot and all-cold SLS bags)
   and at the reference's odd Gram shape (8, 3, 18);
3. serve: ``repro_torch.launch.serve`` at dlrm-rm2's published width
   (26 tables x 1M rows x 64 f32 on the card, 80 lookups, batch 64); the
   kernels' launch counts over that run must be 26 per batch (SLS) and 1
   per batch (Gram), the logits finite, and one batch equal to the same
   forward through the plain versions;
4. time: each kernel, its plain version and one PyTorch call for the same
   function (the yardstick, never called by the port) with CUDA events at
   the main path's inputs, and the serve step per batch;
5. profile: the device's busy share over the serve steps and its time by
   kernel, from a torch.profiler trace.

It prints the card's name and power limit, one JSON line of kernel records
and, last, ``{"ok": true, "device": {...}}``. Without a card it exits 1
and prints no result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.embedding.layout import lookup  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.dot_interaction import dot_interaction  # noqa: E402
from repro_torch.kernels.recflash_sls import recflash_sls  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and f32 FLOP/s
# outside the tensor cores (both kernels add and multiply in f32 on the
# CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the main path: dlrm-rm2 at its published width, full batches of 64
SERVE = dict(arch="dlrm_rm2", requests=512, batch=64, rate=64000.0,
             max_wait_us=1000.0, seed=0)
# f32 sums of up to 80 unit-normal terms in two orders: the worst-case
# rounding bound L * 2^-24 * sum|x| is ~3e-4; bf16 inputs are widened exactly,
# so they share it
KERNEL_TOL = dict(rtol=1e-5, atol=3e-4)
# logits of the kernel-routed forward against the plain-routed one: the bag
# and Gram sums differ in order only (bags are ~1e-2, logits ~1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


def card_line() -> str:
    """``name, power.limit`` of card 0 as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power.limit not measured"


def compare(label: str, got: torch.Tensor, want: torch.Tensor,
            tol: dict) -> float:
    """Print the max abs/rel error of ``got`` against ``want``; raise on a
    miss of the tolerance. Returns the max abs error."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    max_rel = float((diff / want.float().abs().clamp_min(1e-30)).max()) \
        if diff.numel() else 0.0
    ok = bool(torch.allclose(got.float(), want.float(), **tol))
    print(f"[check] {label}: max_abs_err {max_abs:.3e} max_rel_err "
          f"{max_rel:.3e} (rtol {tol['rtol']}, atol {tol['atol']}) "
          f"{'ok' if ok else 'MISS'}")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             "version")
    return max_abs


def time_ms(fn, calls: list[tuple], reps: int = 3) -> float:
    """Device milliseconds per call of ``fn`` over ``calls`` (argument
    tuples, cycled ``reps`` times), by CUDA events. A spin kernel first
    holds the card, so that every launch is queued before the first runs
    and host issue time does not enter the measurement."""
    for args in calls[:3]:
        fn(*args)
    torch.cuda.synchronize()
    n = reps * len(calls)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)      # ~0.1 s at ~2 GHz
    start.record()
    for _ in range(reps):
        for args in calls:
            fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] nvcc -gencode arch=compute_90a,code=sm_90a: "
          f"{', '.join(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_check(gen: torch.Generator) -> dict[str, float]:
    """Each kernel against its plain version on the card."""
    h, v, d, b, lk = 2000, 1_000_000, 64, 64, 80
    dev = torch.device("cuda")
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn(v, d, generator=gen, device=dev).to(dtype)
        hot, cold = table[:h], table[h:]
        mixed = torch.where(
            torch.rand(b, lk, generator=gen, device=dev) < 0.5,
            torch.randint(0, h, (b, lk), generator=gen, device=dev),
            torch.randint(h, v, (b, lk), generator=gen, device=dev))
        cases = {"mixed": mixed,
                 "all-hot": torch.randint(0, h, (b, lk), generator=gen,
                                          device=dev),
                 "all-cold": torch.randint(h, v, (b, lk), generator=gen,
                                           device=dev)}
        for case, idx in cases.items():
            idx = idx.to(torch.int32)
            e = compare(f"recflash_sls {str(dtype)[6:]} {case} "
                        f"(H={h}, V={v}, D={d}, B={b}, L={lk})",
                        recflash_sls(hot, cold, idx),
                        ops.sls_ref(hot, cold, idx), KERNEL_TOL)
            if dtype == torch.float32 and case == "mixed":
                err["recflash_sls"] = e
        del table, hot, cold
    for shape in ((64, 27, 64), (8, 3, 18)):
        for dtype in (torch.float32, torch.bfloat16):
            z = torch.randn(*shape, generator=gen, device=dev).to(dtype)
            e = compare(f"dot_interaction {str(dtype)[6:]} {shape}",
                        dot_interaction(z), ops.dot_ref(z), KERNEL_TOL)
            if dtype == torch.float32 and shape == (64, 27, 64):
                err["dot_interaction"] = e
    return err


def phase_serve() -> tuple[serve_mod.ServeResult, dict[str, int]]:
    """The main path, with the kernels' launch counts over exactly it."""
    recflash_sls.launches = 0
    dot_interaction.launches = 0
    res = serve_mod.serve(device="cuda", **SERVE)
    launches = {"recflash_sls": recflash_sls.launches,
                "dot_interaction": dot_interaction.launches}
    cfg, n_b = res.cfg, len(res.batches)
    print(f"[serve] {cfg.name}: {cfg.n_tables} tables x {cfg.n_rows[0]} rows "
          f"x {cfg.embed_dim} f32 on the card, {cfg.lookups} lookups; "
          f"{res.n_scored} requests in {n_b} batches (sizes "
          f"{[b.size for b in res.batches]})")
    print(f"scored {res.n_scored} requests in {res.t_compute:.2f}s compute "
          f"({1e3 * res.t_compute / n_b:.2f} ms/batch forward, first batch "
          f"included)")
    print(f"[serve] launches: {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = {"recflash_sls": cfg.n_tables * n_b, "dot_interaction": n_b}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if res.n_scored != SERVE["requests"]:
        raise AssertionError(f"scored {res.n_scored} of {SERVE['requests']}")
    for lg, b in zip(res.logits, res.batches, strict=True):
        if lg.shape != (b.size,) or not torch.isfinite(lg).all():
            raise AssertionError("logits are not finite or misshapen")
    plain = dlrm.forward(res.params, res.inputs[0], cfg, plain=True)
    compare("serve batch 0 logits vs the plain-routed forward",
            res.logits[0], plain[:res.batches[0].size], LOGIT_TOL)
    return res, launches


def phase_time(res: serve_mod.ServeResult, launches: dict[str, int],
               err: dict[str, float], gen: torch.Generator) -> list[dict]:
    """Kernel, plain version and yardstick times at the main path's inputs;
    the serve step per batch."""
    p, cfg = res.params, res.cfg
    # every (batch, table) SLS launch of the serve run, with its real ranks
    sls_calls, lib_calls, sls_bytes, sls_flops = [], [], 0.0, 0.0
    for inp in res.inputs:
        for t in range(cfg.n_tables):
            idx = lookup(p["rank_of"][t], inp["indices"][:, t, :])
            stored, h = p["tables"][t], p["hot_sizes"][t]
            sls_calls.append((stored[:h], stored[h:], idx))
            lib_calls.append((idx, stored))
            b, lk = idx.shape
            uniq = int(torch.unique(idx).numel())
            sls_bytes += (uniq * cfg.embed_dim * 4 + idx.numel() * 4
                          + b * cfg.embed_dim * 4)
            sls_flops += b * lk * cfg.embed_dim
    n = len(sls_calls)
    sls_bound, sls_by = bound_ms(sls_bytes / n, sls_flops / n)
    b, t, d = SERVE["batch"], cfg.n_vectors, cfg.embed_dim
    zs = [(torch.randn(b, t, d, generator=gen, device="cuda"),)
          for _ in range(8)]
    dot_bound, dot_by = bound_ms(b * t * d * 4 + b * t * t * 4,
                                 2 * b * t * t * d)
    records = [
        dict(name="recflash_sls", route="cuda",
             source="src/repro_torch/kernels/csrc/recflash_sls.cu",
             replaces="src/repro/kernels/recflash_sls.py:99",
             launches=launches["recflash_sls"],
             max_abs_err=err["recflash_sls"],
             ms=time_ms(recflash_sls, sls_calls),
             plain_ms=time_ms(ops.sls_ref, sls_calls, reps=1),
             bound_ms=sls_bound, bound_by=sls_by,
             library_ms=time_ms(
                 lambda i, w: F.embedding_bag(i, w, mode="sum"), lib_calls)),
        dict(name="dot_interaction", route="cuda",
             source="src/repro_torch/kernels/csrc/dot_interaction.cu",
             replaces="src/repro/kernels/dot_interaction.py:36",
             launches=launches["dot_interaction"],
             max_abs_err=err["dot_interaction"],
             ms=time_ms(dot_interaction, zs, reps=50),
             plain_ms=time_ms(ops.dot_ref, zs, reps=50),
             bound_ms=dot_bound, bound_by=dot_by,
             library_ms=time_ms(lambda z: torch.bmm(z, z.transpose(1, 2)),
                                zs, reps=50)),
    ]
    print(f"[time] recflash_sls over {n} (batch, table) launches of the "
          f"serve run: mean {sls_bytes / n / 1e6:.3f} MB of unique rows, "
          f"indices and output per launch; all-lookup rows would be "
          f"{SERVE['batch'] * cfg.lookups * cfg.embed_dim * 4 / 1e6:.3f} MB")
    for plain in (False, True):
        steps = []
        for inp in res.inputs:
            t0 = time.perf_counter()
            dlrm.forward(p, inp, cfg, plain=plain)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        steps.sort()
        print(f"[time] serve step ({'plain versions' if plain else 'kernels'}"
              f"), warm, per batch of {SERVE['batch']}: median "
              f"{1e3 * steps[len(steps) // 2]:.3f} ms, min "
              f"{1e3 * steps[0]:.3f} ms over {len(steps)} batches")
    return records


def phase_profile(res: serve_mod.ServeResult) -> None:
    """Device busy share of the serve steps, and device time by kernel,
    from a torch.profiler trace of one pass over the batches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for inp in res.inputs:
            dlrm.forward(res.params, inp, res.cfg)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel.setdefault(e.name, []).append(e.time_range.elapsed_us())
    busy_us = sum(sum(v) for v in by_kernel.values())
    n_b = len(res.inputs)
    if not busy_us:
        print("[profile] device busy share: not measured (the profiler "
              "recorded no device time)")
        return
    print(f"[profile] serve steps under the profiler: {wall_us / n_b:.1f} "
          f"us/batch wall, {busy_us / n_b:.1f} us/batch device busy "
          f"({100 * busy_us / wall_us:.1f}% busy, "
          f"{100 * (1 - busy_us / wall_us):.1f}% idle); "
          f"{sum(len(v) for v in by_kernel.values()) / n_b:.0f} device "
          f"activities per batch")
    top = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, times in top:
        print(f"[profile]   {sum(times) / n_b:8.1f} us/batch "
              f"{len(times) / n_b:5.1f}x  {name[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_build()
    err = phase_check(gen)
    res, launches = phase_serve()
    records = phase_time(res, launches, err, gen)
    phase_profile(res)
    for r in records:
        print(f"[time] {r['name']}: {r['ms'] * 1e3:.2f} us/launch "
              f"(plain {r['plain_ms'] * 1e3:.2f} us, library "
              f"{r['library_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.3f} us by {r['bound_by']}) on {card}")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
