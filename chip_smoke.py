#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Phases, each of which fails the run when it fails:

1. build: ``nvcc`` compiles both kernels from ``src/repro_torch/kernels/csrc``
   for sm_90a, one process per source, all at once;
2. check: every kernel entry against its plain PyTorch version on the card,
   in f32 and bf16: the per-table SLS (all-hot and all-cold bags) and the
   grouped SLS over 26 tables x 1M rows with rank_of (and without) at the
   dlrm-rm2 serving shapes, the full Gram and the fused interaction at
   (64, 27, 64) and the reference's odd shape (8, 3, 18);
3. serve: ``repro_torch.launch.serve`` at dlrm-rm2's published width: a
   ``Deployment`` of 26 tables x 1M rows replays the stream through every
   NAND policy lane on the host (simulated flashsim time, printed as the
   reference serve's report), then the card scores the recflash lane's
   batches (26 tables x 1M rows x 64 f32 on the card, 80 lookups, batch
   64); the scored batches must be the lane's, the kernels' launch counts
   over that run one grouped SLS and one fused interaction per lane batch
   and no per-table or full-Gram launch, the logits finite, one batch
   equal to the same forward through the plain versions, and each lane's
   simulated p99 the reference serve's for the same flags;
4. time: each entry, its plain version and its yardstick (one PyTorch call
   for the same function where there is one, never called by the port;
   for the grouped SLS the per-table path it replaced) with CUDA events at
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

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.embedding.layout import lookup  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.dot_interaction import (  # noqa: E402
    dot_interaction, dot_interaction_fused)
from repro_torch.kernels.recflash_sls import (  # noqa: E402
    describe, recflash_sls, recflash_sls_grouped)
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402
from repro_torch.models.common import mlp  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and f32 FLOP/s
# outside the tensor cores (both kernels add and multiply in f32 on the
# CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the main path: dlrm-rm2 at its published width, full batches of 64
SERVE = dict(arch="dlrm_rm2", requests=512, batch=64, rate=64000.0,
             max_wait_us=1000.0, seed=0)
# the reference serve's report for SERVE's flags (``repro.launch.serve
# --arch dlrm_rm2 --requests 512 --rate 64000 --skip-compute``): each lane's
# simulated p99 in ms as its report row prints it
REFERENCE_P99_MS = {"recssd": "203153.24", "rmssd": "58200.97",
                    "recflash": "2508.23"}
# f32 sums of up to 80 unit-normal terms in two orders: the worst-case
# rounding bound L * 2^-24 * sum|x| is ~3e-4; bf16 inputs are widened exactly,
# so they share it
KERNEL_TOL = dict(rtol=1e-5, atol=3e-4)
# device operations queued behind one spin when timing: well under the
# depth of the card's launch queue (about a thousand), past which the host
# blocks until the spin ends
QUEUED_LAUNCHES = 512
# the kernels' launch counters, each reset before the main path and read
# after it
COUNTERS = {"recflash_sls_grouped": recflash_sls_grouped,
            "dot_interaction_fused": dot_interaction_fused,
            "recflash_sls": recflash_sls,
            "dot_interaction": dot_interaction}
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


def time_ms(fn, calls: list[tuple], reps: int = 3, launches: int = 1) -> float:
    """Device milliseconds per call of ``fn`` over ``calls`` (argument
    tuples, cycled ``reps`` times), by CUDA events.

    ``launches`` is about how many device operations one call enqueues. The
    calls run in chunks of at most QUEUED_LAUNCHES operations; before each
    chunk a spin kernel holds the card for three times the host's issue time
    of the chunk (at least 20 ms), so that the whole chunk is queued before
    it runs and host issue time does not enter the measurement. A chunk
    whose spin ended before its last call was queued is run again with a
    longer spin.
    """
    warm = calls[:3]
    for args in warm:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in warm:
        fn(*args)
    issue_s = (time.perf_counter() - t0) / len(warm)
    torch.cuda.synchronize()
    todo = calls * reps
    per_chunk = max(1, QUEUED_LAUNCHES // launches)
    total_ms = 0.0
    for i in range(0, len(todo), per_chunk):
        chunk = todo[i:i + per_chunk]
        spin_s = max(0.02, 3 * issue_s * len(chunk))
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(spin_s * 2e9))    # cycles at ~2 GHz
            start.record()
            for args in chunk:
                fn(*args)
            end.record()
            spun_out = start.query()   # the card reached the chunk early
            torch.cuda.synchronize()
            if not spun_out:
                total_ms += start.elapsed_time(end)
                break
            spin_s *= 4
        else:
            raise AssertionError("host issue outlasted every spin: not "
                                 "measured")
    return total_ms / len(todo)


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
    """Every kernel entry against its plain version on the card."""
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
    err["recflash_sls_grouped"] = check_grouped(gen)
    for shape in ((64, 27, 64), (8, 3, 18)):
        for dtype in (torch.float32, torch.bfloat16):
            z = torch.randn(*shape, generator=gen, device=dev).to(dtype)
            e = compare(f"dot_interaction {str(dtype)[6:]} {shape}",
                        dot_interaction(z), ops.dot_ref(z), KERNEL_TOL)
            x, bags = z[:, 0].contiguous(), z[:, 1:].contiguous()
            ef = compare(f"dot_interaction_fused {str(dtype)[6:]} {shape}",
                         dot_interaction_fused(x, bags),
                         ops.fused_ref(x, bags), KERNEL_TOL)
            if dtype == torch.float32 and shape == (64, 27, 64):
                err["dot_interaction"], err["dot_interaction_fused"] = e, ef
    return err


def check_grouped(gen: torch.Generator) -> float:
    """The grouped SLS over dlrm-rm2's 26 tables x 1M rows x 64, hot sizes
    from 1 row to the whole table, ids through random rank_of tables (and
    ranks without them); returns the f32 mixed case's max abs error."""
    n_t, v, d, b, lk = 26, 1_000_000, 64, 64, 80
    dev = torch.device("cuda")
    hot = [1, 2000, v] + [1000 * (t + 1) for t in range(n_t - 3)]
    rank_of = [torch.randperm(v, generator=gen, device=dev).to(torch.int32)
               for _ in range(n_t)]
    perm = [r.argsort() for r in rank_of]          # rank -> logical id

    def ids(lo, hi):
        """(B, n_t, L) logical ids whose ranks lie in [lo_t, hi_t)."""
        cols = []
        for t in range(n_t):
            ranks = lo[t] + (torch.rand(b, lk, generator=gen, device=dev)
                             * (hi[t] - lo[t])).long()
            cols.append(perm[t][ranks])
        return torch.stack(cols, dim=1).to(torch.int32)

    cases = {"mixed": ids([0] * n_t, [v] * n_t),
             "all-hot": ids([0] * n_t, hot),
             "all-cold": ids([min(h, v - 1) for h in hot], [v] * n_t)}
    first = None
    for dtype in (torch.float32, torch.bfloat16):
        tables = list(torch.randn(n_t * v, d, generator=gen, device=dev)
                      .to(dtype).split(v))
        desc = describe(tables, hot, rank_of)
        for case, idx in cases.items():
            e = compare(f"recflash_sls_grouped {str(dtype)[6:]} {case} "
                        f"({n_t} tables x {v} rows, D={d}, B={b}, L={lk}, "
                        f"rank_of)",
                        recflash_sls_grouped(tables, hot, idx, rank_of, desc),
                        ops.sls_grouped_ref(tables, hot, idx, rank_of),
                        KERNEL_TOL)
            first = e if first is None else first
        ranks = cases["mixed"]          # any ids in [0, V) serve as ranks
        compare(f"recflash_sls_grouped {str(dtype)[6:]} ranks, no rank_of",
                recflash_sls_grouped(tables, hot, ranks),
                ops.sls_grouped_ref(tables, hot, ranks), KERNEL_TOL)
        del tables, desc
    return first


def phase_serve() -> tuple[serve_mod.ServeResult, dict[str, int]]:
    """The main path, with the kernels' launch counts over exactly it."""
    for fn in COUNTERS.values():
        fn.launches = 0
    res = serve_mod.serve(device="cuda", **SERVE)
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    cfg, lane = res.cfg, res.traces["recflash"].batches
    n_b = len(lane)
    print(f"[serve] host set-up {res.t_setup:.2f} s (Deployment: offline "
          f"sweep and {len(res.traces)} policy lanes over {cfg.n_tables} "
          f"tables x {cfg.n_rows[0]} rows; the stream), replay of every lane "
          f"{res.t_sim:.2f} s, remapped tables on the card {res.t_model:.2f} s")
    print("[serve] per-policy report, simulated flashsim time (not card "
          "time):")
    for line in serve_mod.report_lines(res):
        if line.strip():
            print(f"[serve]   {line.strip()}")
    print(f"[serve] {cfg.name}: {cfg.n_tables} tables x {cfg.n_rows[0]} rows "
          f"x {cfg.embed_dim} f32 on the card, {cfg.lookups} lookups; "
          f"{res.n_scored} requests in the recflash lane's {n_b} batches "
          f"(sizes {[b.size for b in lane]})")
    print(f"scored {res.n_scored} requests in {res.t_compute:.2f}s compute "
          f"({1e3 * res.t_compute / n_b:.2f} ms/batch forward, first batch "
          f"included)")
    print(f"[serve] launches: {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(res.inputs) != n_b:
        raise AssertionError(f"scored {len(res.inputs)} batches, the lane "
                             f"formed {n_b}")
    for inp, b in zip(res.inputs, lane, strict=True):
        rows = np.stack([r.rows.reshape(cfg.n_tables, cfg.lookups)
                         for r in b.requests])
        if not np.array_equal(inp["indices"][:b.size].cpu().numpy(), rows):
            raise AssertionError("a scored batch is not the recflash "
                                 "lane's batch")
    want = {"recflash_sls_grouped": n_b, "dot_interaction_fused": n_b,
            "recflash_sls": 0, "dot_interaction": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if res.n_scored != SERVE["requests"]:
        raise AssertionError(f"scored {res.n_scored} of {SERVE['requests']}")
    for lg, b in zip(res.logits, lane, strict=True):
        if lg.shape != (b.size,) or not torch.isfinite(lg).all():
            raise AssertionError("logits are not finite or misshapen")
    plain = dlrm.forward(res.params, res.inputs[0], cfg, plain=True)
    compare("serve batch 0 logits vs the plain-routed forward",
            res.logits[0], plain[:lane[0].size], LOGIT_TOL)
    return res, launches


def check_report(res: serve_mod.ServeResult) -> None:
    """Each lane's simulated p99 against the reference serve's report for
    the same flags (checked last, so that a miss leaves the timings)."""
    got = {pol: f"{tr.report.p99_us / 1e3:.2f}"
           for pol, tr in res.traces.items()}
    print(f"[check] simulated p99 ms per lane {got}, reference "
          f"{REFERENCE_P99_MS}")
    if got != REFERENCE_P99_MS:
        raise AssertionError("the policy lanes' report differs from the "
                             "reference serve's")


def per_table_bags(p: dict, indices: torch.Tensor) -> torch.Tensor:
    """The per-table path the grouped launch replaced: per table an index
    copy, the rank_of gather and a per-table SLS launch, then a stack."""
    return torch.stack([dlrm._bag(p, indices[:, t, :], t)
                        for t in range(indices.shape[1])], dim=1)


def per_table_forward(p: dict, batch: dict, cfg) -> torch.Tensor:
    """The forward with the per-table SLS launches and the full-Gram
    interaction (cat, Gram, triangle gather, cat): the launch structure
    the grouped and fused entries replaced."""
    x = mlp(p["bot"], batch["dense"])
    z = torch.cat([x[:, None, :], per_table_bags(p, batch["indices"])], 1)
    feat = torch.cat([x, ops.dot_interaction(z)], dim=1)
    return mlp(p["top"], feat)[:, 0]


def phase_time(res: serve_mod.ServeResult, launches: dict[str, int],
               err: dict[str, float]) -> list[dict]:
    """Entry, plain version and yardstick times at the main path's inputs;
    the serve step per batch."""
    p, cfg = res.params, res.cfg
    n_t, dim, lk = cfg.n_tables, cfg.embed_dim, cfg.lookups
    # every batch of the serve run, and every (batch, table) of it, with its
    # real ids and ranks
    grouped_calls, bag_calls, sls_calls, lib_calls = [], [], [], []
    g_bytes = sls_bytes = 0.0
    for inp in res.inputs:
        idx = inp["indices"]
        grouped_calls.append((p["tables"], p["hot_sizes"], idx, p["rank_of"],
                              p["sls_desc"]))
        bag_calls.append((p, idx))
        b = idx.shape[0]
        g_bytes += idx.numel() * 4 + b * n_t * dim * 4
        for t in range(n_t):
            ranks = lookup(p["rank_of"][t], idx[:, t, :])
            stored, h = p["tables"][t], p["hot_sizes"][t]
            sls_calls.append((stored[:h], stored[h:], ranks))
            lib_calls.append((ranks, stored))
            rows = int(torch.unique(ranks).numel()) * dim * 4
            g_bytes += rows + int(torch.unique(idx[:, t, :]).numel()) * 4
            sls_bytes += rows + ranks.numel() * 4 + b * dim * 4
    n_b, n = len(grouped_calls), len(sls_calls)
    flops = SERVE["batch"] * lk * dim
    g_bound, g_by = bound_ms(g_bytes / n_b, n_t * flops)
    sls_bound, sls_by = bound_ms(sls_bytes / n, flops)
    # the fused interaction's real inputs: bottom MLP outputs and bags
    fused_calls = [(mlp(p["bot"], inp["dense"]), dlrm.bags(p, inp["indices"]))
                   for inp in res.inputs]
    zs = [(torch.cat([x[:, None], bg], 1),) for x, bg in fused_calls]
    b, t = SERVE["batch"], cfg.n_vectors
    iu, ju = torch.triu_indices(t, t, 1, device=zs[0][0].device)

    def bmm_path(x, bags):
        z = torch.cat([x[:, None], bags], 1)
        return torch.cat([x, torch.bmm(z, z.transpose(1, 2))[:, iu, ju]], 1)

    n_tri = t * (t - 1) // 2
    fused_bound, fused_by = bound_ms(b * t * dim * 4 + b * (dim + n_tri) * 4,
                                     2 * b * n_tri * dim)
    dot_bound, dot_by = bound_ms(b * t * dim * 4 + b * t * t * 4,
                                 2 * b * t * t * dim)
    bmm_ms = time_ms(lambda z: torch.bmm(z, z.transpose(1, 2)), zs, reps=50)
    sls_src = dict(route="cuda",
                   source="src/repro_torch/kernels/csrc/recflash_sls.cu",
                   replaces="src/repro/kernels/recflash_sls.py:99")
    dot_src = dict(route="cuda",
                   source="src/repro_torch/kernels/csrc/dot_interaction.cu",
                   replaces="src/repro/kernels/dot_interaction.py:36")
    records = [
        dict(name="recflash_sls", entry="recflash_sls_grouped", **sls_src,
             launches=launches["recflash_sls_grouped"],
             max_abs_err=err["recflash_sls_grouped"],
             ms=time_ms(recflash_sls_grouped, grouped_calls, reps=20),
             plain_ms=time_ms(ops.sls_grouped_ref,
                              [c[:4] for c in grouped_calls], reps=1,
                              launches=6 * n_t),
             bound_ms=g_bound, bound_by=g_by, library_ms=None,
             library_note="no single PyTorch call translates ids through "
                          "each table's rank_of and sums the two-tier bags "
                          "of all tables",
             yardstick="the per-table path it replaced: per table an index "
                       "copy, the rank_of index_select and a per-table SLS "
                       "launch, then torch.stack",
             yardstick_ms=time_ms(per_table_bags, bag_calls, reps=5,
                                  launches=4 * n_t),
             entries=[dict(
                 name="recflash_sls", entry="per-table", **sls_src,
                 launches=launches["recflash_sls"],
                 max_abs_err=err["recflash_sls"],
                 ms=time_ms(recflash_sls, sls_calls),
                 plain_ms=time_ms(ops.sls_ref, sls_calls, reps=1,
                                  launches=4),
                 bound_ms=sls_bound, bound_by=sls_by,
                 library_ms=time_ms(
                     lambda i, w: F.embedding_bag(i, w, mode="sum"),
                     lib_calls, launches=6))]),
        dict(name="dot_interaction", entry="dot_interaction_fused", **dot_src,
             launches=launches["dot_interaction_fused"],
             max_abs_err=err["dot_interaction_fused"],
             ms=time_ms(dot_interaction_fused, fused_calls, reps=50),
             plain_ms=time_ms(ops.fused_ref, fused_calls, reps=50,
                              launches=10),
             bound_ms=fused_bound, bound_by=fused_by, library_ms=None,
             library_note="no single PyTorch call writes [bottom_out, "
                          "upper-triangle dots]",
             yardstick="torch.cat, torch.bmm, triangle gather, torch.cat",
             yardstick_ms=time_ms(bmm_path, fused_calls, reps=50,
                                  launches=8),
             bmm_ms=bmm_ms,
             entries=[dict(
                 name="dot_interaction", entry="full Gram", **dot_src,
                 launches=launches["dot_interaction"],
                 max_abs_err=err["dot_interaction"],
                 ms=time_ms(dot_interaction, zs, reps=50),
                 plain_ms=time_ms(ops.dot_ref, zs, reps=50, launches=4),
                 bound_ms=dot_bound, bound_by=dot_by, library_ms=bmm_ms)]),
    ]
    print(f"[time] recflash_sls_grouped over the {n_b} batches of the serve "
          f"run: mean {g_bytes / n_b / 1e6:.3f} MB of unique rows, unique "
          f"rank_of entries, indices and output per batch; per-table "
          f"launches: mean {sls_bytes / n / 1e6:.3f} MB")
    print(f"[time] torch.bmm alone on the interaction's z ({b}, {t}, {dim}) "
          f"f32: {bmm_ms * 1e3:.2f} us")
    forwards = {"kernels": lambda inp: dlrm.forward(p, inp, cfg),
                "plain versions": lambda inp: dlrm.forward(p, inp, cfg,
                                                           plain=True),
                "per-table path": lambda inp: per_table_forward(p, inp, cfg)}
    for label, fwd in forwards.items():
        steps = []
        for inp in res.inputs:
            t0 = time.perf_counter()
            fwd(inp)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        steps.sort()
        print(f"[time] serve step ({label}), warm, per batch of "
              f"{SERVE['batch']}: median {1e3 * steps[len(steps) // 2]:.3f} "
              f"ms, min {1e3 * steps[0]:.3f} ms over {len(steps)} batches")
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
    records = phase_time(res, launches, err)
    phase_profile(res)
    check_report(res)
    for r in records:
        for e in [r, *r["entries"]]:
            yard = (f"library {e['library_ms'] * 1e3:.2f} us"
                    if e["library_ms"] is not None else
                    f"yardstick {e['yardstick_ms'] * 1e3:.2f} us")
            print(f"[time] {e['name']} ({e['entry']}): {e['ms'] * 1e3:.2f} "
                  f"us/launch, {e['launches']} launches (plain "
                  f"{e['plain_ms'] * 1e3:.2f} us, {yard}, bound "
                  f"{e['bound_ms'] * 1e3:.3f} us by {e['bound_by']}) on "
                  f"{card}")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
