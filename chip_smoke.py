#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Phases, each of which fails the run when it fails:

1. build: ``nvcc`` compiles the three kernels from
   ``src/repro_torch/kernels/csrc`` for sm_90a, one process per source, all
   at once (flash attention's 18 template instances, nine a route, take
   the longest, the others a few s), and the wgmma instructions in the
   flash library's SASS counted;
2. check: every kernel entry against its plain PyTorch version on the card,
   in f32 and bf16: the per-table SLS (all-hot and all-cold bags) and the
   grouped SLS over 26 tables x 1M rows with rank_of (and without) at the
   dlrm-rm2 serving shapes, the full Gram and the fused interaction at
   (64, 27, 64) and the reference's odd shape (8, 3, 18); flash
   attention, forward (out, lse) and backward (dq, dk, dv), at
   qwen3-1.7b's prefill shape, deepseek's MLA shape (qk 192, v 128, v a
   split view) and a context-parallel block (explicit q_start): float32
   on its CUDA-core route, bf16 on its wgmma route;
3. serve: ``repro_torch.launch.serve`` at dlrm-rm2's published width: a
   ``Deployment`` of 26 tables x 1M rows replays the stream through every
   NAND policy lane on the host (simulated flashsim time, printed as the
   reference serve's report), then the card scores the recflash lane's
   batches (26 tables x 1M rows x 64 f32 on the card, 80 lookups, batch
   64); the scored batches must be the lane's; the forward's first batch
   runs eagerly (one grouped SLS and one fused interaction counted by
   their wrappers, no per-table or full-Gram launch) and is captured as a
   CUDA graph, which every later batch replays (``dlrm.forward``'s
   counters); a device trace of the run must hold one SLS and one
   interaction kernel a lane batch; the logits finite, each batch equal to
   the same forward through the plain versions, and each lane's simulated
   p99 the reference serve's for the same flags;
4. retrieval: ``dlrm.retrieval_score`` on the served model, 1 user x
   1,000,000 candidates (the retrieval_cand shape): one grouped SLS, one
   per-table SLS and one fused interaction launch, the scores equal to the
   plain-routed version's, its time per call;
5. time: each entry, its plain version and its yardstick (one PyTorch call
   for the same function where there is one, never called by the port;
   for the grouped SLS the per-table path it replaced) with CUDA events at
   the main path's inputs, and the serve step per batch; the grouped and
   fused entries and their backwards (plain PyTorch) also at the training
   batch of 4096;
6. profile: the device's busy share over the serve steps and its time by
   kernel, from a torch.profiler trace;
7. train: ``repro_torch.launch.train``'s DLRM pipeline at dlrm-rm2's width
   (remap on, batch 4096), a few steps through ``TrainLoop`` with one
   checkpoint: one grouped SLS and one fused interaction per step and no
   other launch, finite losses, the step's time split into forward,
   backward and optimizer, peak device memory, the checkpoint's bytes and
   seconds; one step's loss and gradients through the kernels'
   ``autograd.Function``s against autograd of the plain-routed forward;
   then, at ``small_dlrm``, a crashed-and-resumed ``TrainLoop`` against an
   uninterrupted one, and the training CLI run and resumed as the
   reference's tests/test_launch.py drives it;
8. sharded: the distributed embedding over NCCL at world size 1 (one card
   holds one rank): a (1, 1) ("data", "model") mesh, dlrm-rm2 at full
   width with remap on; a served batch of 64 through the mesh forward
   three ways (the masked-psum two-phase path, hybrid, hybrid with 2D
   tables) against the single-device kernel forward, one training step at
   batch 4096 through the 2D hybrid loss against the single-device step,
   ``compressed_psum`` on a real gradient against its own quantise and
   dequantise, and a small_dlrm checkpoint restored onto shardings; the
   warm steps, the collectives per step by kind and the launches;
9. bf16: the served dlrm-rm2 model cast to bf16 (26 x 1M x 64 bf16, 3.33
   GB, remap on): the three kernel entries in bf16 against their plain
   versions at the serve shapes; then, counted, the serve lane's batches
   (bf16 dense features, so bf16 bags, top-MLP input and logits), one
   retrieval of 1 x 1M and one training step at batch 4096 (row-wise
   adagrad and AdamW, float32 state) through the kernels; the logits and
   scores against the plain route at the bf16 tolerance, the Functions'
   gradients against plain autograd; each timed with CUDA events;
10. recsys: DIN, BERT4Rec and GraphSAGE at the registry's configs, each
   run on the card and held against the same port function on the CPU
   with the same params (DIN forward at serve_p99, loss and gradients at
   4096, retrieval of 1 x 1M in chunks; BERT4Rec score at 512, cloze loss
   and gradients at 1024, retrieval of 1 x 1M ids; GraphSAGE sampled
   Reddit-scale loss and gradients, Cora full-graph loss and gradients,
   128 batched molecule graphs); they launch none of the port's kernels;
11. lm: the LM family in bf16, as the reference's serve cells run it:
   qwen3-1.7b at full width and depth (prefill at (8, 4096), then 32
   teacher-forced decode steps over a cache of 4,128 slots), qwen2-0.5b,
   nemotron-4-15b, qwen3-moe-30b-a3b and deepseek-v3-671b at full width
   with their depth cut; times, tokens/s and peak memory beside their
   bounds, the logits finite and their bf16 drift from the full forward;
   the reference's decode-vs-full property held per arch in float32 at
   full width (MoE archs with capacity = tokens); deepseek's train_loss
   with MTP, forward and backward; the narrow variants card against CPU;
   lm-100m training in process and through ``python -m
   repro_torch.launch.train --model lm``, run and resumed; the phase's
   attention runs through the flash attention kernel (forward launches
   at least its layers times its calls, backward launches in training;
   the bf16 ones on the wgmma route) and no DLRM kernel; after the
   counted path, the kernel's times beside the plain version,
   ``F.scaled_dot_product_attention`` (a yardstick the path never calls)
   and the bound, bf16 and float32;
12. lm_mesh: the LM under a (1, 1) ("data", "model") mesh over NCCL at
   world size 1, through the registry's plans (``configs.get_arch``) at
   full width with the depth cut as in phase 11, each against the same
   plan without a mesh, the Megatron TP, FSDP and split-K code run at
   axis size 1: qwen3-moe-30b-a3b's prefill at (8, 4096) (sharded
   expert parallelism) and 32 decode steps (the 2D serving layout),
   deepseek-v3-671b's prefill at (2, 4096) (2D, in chunks of 2048 tokens,
   against the mesh-free MoE over the same chunks) and 32 decode steps,
   qwen2-0.5b's context-parallel prefill at (8, 4096) and one step of its
   train plan (sequence sharding, AdamW): logits, caches, loss, every
   gradient and every updated param, the mesh and mesh-free times, the
   collectives per call and the peak memory; attention through the flash
   attention kernel, no DLRM kernel;
13. registry (after recsys): the registry's plans (``configs.get_arch``)
   with mesh None on real tensors at their full shapes: dlrm-mlperf in bf16
   (26 tables, 48.07 GB, and 0.75 GB of rank_of permutations made on the
   card) through serve_p99 (512), serve_bulk (262,144) and retrieval_cand
   (1 x 1M), dlrm-rm2 and rmc1-3 through serve_p99 and retrieval_cand,
   each table's last id and the id of its last stored row in every batch;
   one counted call of each through the kernels (one grouped SLS and one
   fused interaction launch, retrieval one per-table SLS more) held against
   the same plan built with plain=True, then timed; both kernels timed at
   each arch's serve inputs (D 128 bf16, D 32, T 9, 11 and 33); one
   train_batch step of dlrm-rm2 at 65,536 samples, its loss against the
   plain route's on the same batch; DIN's and BERT4Rec's serve_p99 and
   GraphSAGE's molecule and full_graph_sm steps, card against CPU; peak
   memory per arch;
14. dcn: MLPerf's DLRM-DCNv2 (``configs.dlrm_dcnv2``) at its published
   widths and bag lengths on bf16 tables cut to ``DCN_ROWS`` rows: the
   grouped SLS over its ragged bags (1 to 100 ids a table, 214 a sample)
   against its plain version bit for bit in f32 and bf16 at D=128, a
   uniform launch against a ragged one of the same bags, bit for bit; the
   forward's graph replay at 64 rows against its eager call, bit for bit;
   the eager forward at ``DCN_BATCH`` against ``plain=True``; the ragged
   launch and the forward timed with CUDA events;
15. sls_probe: the grouped SLS at rmc2's shape (32 f32 tables of 1M x
   64, 2000 hot rows each, batch 4096, 120 lookups) on ids whose ranks put
   every lookup in one level of the cache (``tools/sls_probe.py``): one
   hot rank a table, the first 64 ranks, all-distinct cold ranks, and the
   bulk cells' Zipf traffic at K=0 and K=2; ms a launch beside its bound
   (unique rows, ``rank_of`` entries, ids and bags at 3.35 TB/s) and the
   rate at which it reads rows, where the head is served from and how
   far each case stands from its bound;
16. dryrun: ``python -m repro_torch.launch.dryrun --mesh single`` in two
   subprocesses at once, over the cells the next two phases read
   (qwen3-1.7b's, deepseek-v3-671b's decode_32k, DIN's and BERT4Rec's):
   each cell's plan run on rank 0's blocks of meta tensors under a fake
   256-rank group, its per-rank flops, bytes, wire bytes, H100 roofline
   bound, peak and ``fits_hbm`` printed; any failed cell fails the run;
17. recsys_mesh: DIN's and BERT4Rec's registry cells with their item
   tables row-sharded over ``model`` (masked lookups summed over it,
   BERT4Rec's tied output and cloze loss on the rank's vocab block):
   train_batch, serve_p99, serve_bulk and retrieval_cand through the
   plans on a (1, 1) NCCL mesh at the registry's widths (DIN 1M x 18,
   BERT4Rec 26,752 x 64; BERT4Rec's serve_bulk cut to 16,384 rows),
   each against the same plan without a mesh: outputs, loss, gradients,
   the params and optimizer state after a step; then rank 0's blocks of
   the 16 x 16 mesh on the card under the fake group, per-call time and
   peak memory beside the dry-run's counted peak; no launch of any
   kernel;
18. lm_blocks (last): rank 0's blocks of the 16 x 16 production mesh as
   real tensors on the card, at full width and depth, under the fake
   256-rank group this process starts (its collectives move nothing):
   qwen3-1.7b's train_4k, prefill_32k and decode_32k and
   deepseek-v3-671b's decode_32k through the plans' ``fn``; per-call time
   and peak memory (compute only, collectives not run) beside the
   dry-run's counted peak; attention through the flash attention kernel
   (decode's stays plain), no DLRM kernel.

It prints the card's name and power limit, one JSON line of kernel records
and, last, ``{"ok": true, "device": {...}}``. Without a card it exits 1
and prints no result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import checkpoint, configs, optim, tree  # noqa: E402
from repro_torch.data.tracegen import generate_sls_batch  # noqa: E402
from repro_torch.distributed import mesh as dmesh  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    CompressionState, compressed_psum)
from repro_torch.distributed.shardings import (  # noqa: E402
    NamedSharding, P, make_param_specs, sync_grads)
from repro_torch.embedding.layout import lookup  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.dot_interaction import (  # noqa: E402
    dot_interaction, dot_interaction_fused, dot_interaction_fused_backward)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bucket as fa_bucket, flash_attention_bwd, flash_attention_fwd,
    route as fa_route)
from repro_torch.kernels.recflash_sls import (  # noqa: E402
    describe, recflash_sls, recflash_sls_grouped,
    recflash_sls_grouped_backward)
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402
from repro_torch.models.common import mlp  # noqa: E402
from repro_torch.runtime import LoopConfig, StepFailure, TrainLoop  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and f32 FLOP/s
# outside the tensor cores (both kernels add and multiply in f32 on the
# CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the bf16 tensor-core peak: the least time for a bf16 entry's operations
# (the kernels widen bf16 and add in f32 on the CUDA cores; bytes bound
# them either way)
BF16_FLOPS = 989e12
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
# a bf16 output (the bags and the fused interaction store the inputs'
# dtype) is each side's f32 sum rounded once: besides KERNEL_TOL's
# difference of the sums, the two roundings may land one bf16 ulp apart,
# 2^-7 relative at most
BF16_KERNEL_TOL = dict(rtol=2**-7, atol=3e-4)
# a bf16 model's logits and scores, kernel route against plain route: the
# reference's bf16 tolerance (tests/test_kernels.py)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_GRAD_REL_L2 = 2e-2
# the recsys models on the card against the same function on the CPU, f32
# with TF32 off: cuBLAS and the CPU's BLAS (and index_add_'s atomics) sum
# in other orders, each product O(1e-7) relative; each gradient tensor is
# held as a whole, with the margin a batch sum that cancels needs (two f32
# routes of the DLRM training step have differed by 3e-4 on a bias
# gradient: tools/train_grad_probe.py). A bias added
# before a softmax over the positions it shifts (DIN's last attention
# layer, BERT4Rec's key projections) has an exactly zero gradient, so on
# either device its value is rounding noise; it is held joined to its
# layer's weight.
RECSYS_TOL = dict(rtol=1e-4, atol=1e-5)
RECSYS_GRAD_REL_L2 = 1e-3
# device operations queued behind one spin when timing: well under the
# depth of the card's launch queue (about a thousand), past which the host
# blocks until the spin ends
QUEUED_LAUNCHES = 512
# the kernels' launch counters, each reset before the main path and read
# after it
COUNTERS = {"recflash_sls_grouped": recflash_sls_grouped,
            "dot_interaction_fused": dot_interaction_fused,
            "recflash_sls": recflash_sls,
            "dot_interaction": dot_interaction,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd}
DLRM_KERNELS = ("recflash_sls_grouped", "dot_interaction_fused",
                "recflash_sls", "dot_interaction")
# flash attention's launches by route (``kernels.flash_attention.route``:
# wgmma for bf16, cuda_cores for float32), reset and read with the counters
ROUTED = {"flash_attention_fwd": flash_attention_fwd,
          "flash_attention_bwd": flash_attention_bwd}
# logits of the kernel-routed forward against the plain-routed one: the bag
# and Gram sums differ in order only (bags are ~1e-2, logits ~1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
# the training path: launch/train.py's DLRM pipeline at dlrm-rm2's width,
# its flags as Namespace fields (the CLI's defaults but the batch)
TRAIN = dict(seed=0, batch=4096, lr=1e-3, lr_table=0.02, device="cuda")
TRAIN_STEPS = 8
# retrieval_cand (src/repro/configs/recsys_common.py): 1 user x 1M items
N_CANDIDATES = 1_000_000
# one step's loss through the Functions against the plain-routed loss, and
# its gradients: f32 sums over the 4096-sample batch, the 27 interaction
# vectors and index_add_'s atomics, in other orders. An entry where a batch
# sum cancels (a bias gradient far below its per-sample terms) keeps the
# absolute error of those terms, so each gradient tensor is held as a
# whole: ||got - want|| <= GRAD_REL_L2 * ||want||. The same holds a resumed
# run's state against an uninterrupted one's (atomics again). The plain
# SLS adds each bag's rows in lookup order, as the kernel does
# (``kernels.ref.sum_in_order``): forwards that round a bag differently can
# flip a ReLU at its kink, which a cancelling batch sum carries past any
# such limit (tools/train_grad_probe.py measures it). Both routes are also
# read against the float64 plain-routed gradient, and printed.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL_L2 = 1e-4
# GraphSAGE's Reddit-scale graph (repro.configs.graphsage_reddit
# "minibatch_lg"): synthetic, with Reddit's node count, features and mean
# in-degree (114,615,892 edges / 232,965 nodes)
SAGE_AVG_DEGREE = (configs.SAGE_SHAPES["minibatch_lg"]["n_edges"]
                   // configs.SAGE_SHAPES["minibatch_lg"]["n_nodes"])


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
        raise AssertionError(f"{label}: the two disagree beyond the "
                             "tolerance")
    return max_abs


def out_tol(dtype: torch.dtype) -> dict:
    """The kernel-against-plain tolerance for an output of ``dtype``."""
    return KERNEL_TOL if dtype == torch.float32 else BF16_KERNEL_TOL


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


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sls_bytes(p: dict, inputs: list[dict]) -> tuple[float, float]:
    """The bytes the SLS must move for the batches ``inputs`` of the
    remapped model ``p``: per grouped launch (each batch's unique rows and
    rank_of entries, its indices and bags) and per per-table launch (a
    table's unique rows, its ranks and bags), in the tables' dtype."""
    n_t, dim = len(p["tables"]), p["tables"][0].shape[1]
    esize = p["tables"][0].element_size()
    grouped = per_table = 0.0
    for inp in inputs:
        idx = inp["indices"]
        b = idx.shape[0]
        grouped += idx.numel() * 4 + b * n_t * dim * esize
        for t in range(n_t):
            ranks = lookup(p["rank_of"][t], idx[:, t, :])
            rows = int(torch.unique(ranks).numel()) * dim * esize
            grouped += rows + int(torch.unique(idx[:, t, :]).numel()) * 4
            per_table += rows + ranks.numel() * 4 + b * dim * esize
    return grouped / len(inputs), per_table / (len(inputs) * n_t)


def phase_build() -> dict:
    """Build every kernel source at once (flash attention's is the slowest,
    so the phase's seconds are its own); print the kernels' registers and
    spills. Returns the seconds and the flash attention library's
    warpgroup products (HGMMA, what wgmma.mma_async compiles to) counted
    in its SASS by shape; none fails the run."""
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] nvcc -gencode arch=compute_90a,code=sm_90a: "
          f"{', '.join(_build.SOURCES)} in {build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True).stdout
    hgmma: dict[str, int] = {}
    for op in re.findall(r"HGMMA\.(\w+)", sass):
        hgmma[op] = hgmma.get(op, 0) + 1
    print(f"[build] flash_attention's SASS: HGMMA by shape {hgmma}")
    if not hgmma:
        raise AssertionError("the flash attention library has no wgmma")
    return dict(build_s=build_s, sass_hgmma=hgmma)


def phase_check(gen: torch.Generator) -> dict[str, float]:
    """Every kernel entry against its plain version on the card; returns
    each entry's float32 max abs error at the main path's shapes."""
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
                        ops.sls_ref(hot, cold, idx), out_tol(dtype))
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
                         ops.fused_ref(x, bags), out_tol(dtype))
            if dtype == torch.float32 and shape == (64, 27, 64):
                err["dot_interaction"], err["dot_interaction_fused"] = e, ef
    err.update(phase_attention_check(gen))
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
                        out_tol(dtype))
            first = e if first is None else first
        ranks = cases["mixed"]          # any ids in [0, V) serve as ranks
        compare(f"recflash_sls_grouped {str(dtype)[6:]} ranks, no rank_of",
                recflash_sls_grouped(tables, hot, ranks),
                ops.sls_grouped_ref(tables, hot, ranks), out_tol(dtype))
        del tables, desc
    return first


def kernel_runs(events) -> dict[str, int]:
    """How often the card ran the SLS and interaction kernels in a trace's
    events: the runs of a CUDA graph's kernels too, which no wrapper
    counts."""
    from torch.autograd import DeviceType
    names = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
    return {k: sum(k in n for n in names)
            for k in ("sls_kernel", "interaction_kernel")}


def phase_serve() -> tuple[serve_mod.ServeResult, dict[str, int]]:
    """The main path, with the kernels' launch counts over exactly it: the
    wrappers' (the eager calls: a graph bucket's first batch), the graph
    route's captures and replays (``dlrm.forward``), and the kernels' runs
    on the card from a device trace of the same run, one SLS and one
    interaction a batch."""
    from torch.profiler import ProfilerActivity, profile
    reset_counts()
    graphs0 = (dlrm.forward.graph_captures, dlrm.forward.graph_replays)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = serve_mod.serve(device="cuda", **SERVE)
        torch.cuda.synchronize()
    launches = read_counts()
    captures = dlrm.forward.graph_captures - graphs0[0]
    replays = dlrm.forward.graph_replays - graphs0[1]
    ran = kernel_runs(prof.profiler.kineto_results.events())
    cfg, lane = res.cfg, res.traces["recflash"].batches
    n_b = len(lane)
    buckets = len({dlrm.graph_bucket(inp["dense"].shape[0])
                   for inp in res.inputs})
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
          f"({1e3 * res.t_compute / n_b:.2f} ms/batch forward under the "
          f"profiler, first batch included)")
    print(f"[serve] launches: {launches}; graph captures {captures}, "
          f"replays {replays}; kernels run on the card (device trace) "
          f"{ran}; peak device memory "
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
    want = counts(recflash_sls_grouped=buckets, dot_interaction_fused=buckets)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if (captures, replays) != (buckets, n_b - buckets):
        raise AssertionError(f"{captures} graph captures and {replays} "
                             f"replays over {n_b} batches in {buckets} "
                             f"buckets")
    if ran != {"sls_kernel": n_b, "interaction_kernel": n_b}:
        raise AssertionError(f"the card ran {ran} over {n_b} batches")
    if res.n_scored != SERVE["requests"]:
        raise AssertionError(f"scored {res.n_scored} of {SERVE['requests']}")
    for i, (lg, inp, b) in enumerate(zip(res.logits, res.inputs, lane,
                                         strict=True)):
        if lg.shape != (b.size,) or not torch.isfinite(lg).all():
            raise AssertionError("logits are not finite or misshapen")
        plain = dlrm.forward(res.params, inp, cfg, plain=True)
        compare(f"serve batch {i} logits vs the plain-routed forward", lg,
                plain[:b.size], LOGIT_TOL)
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


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    for fn in ROUTED.values():
        fn.routes = dict.fromkeys(fn.routes, 0)


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def read_routes() -> dict[str, dict[str, int]]:
    """Each flash attention wrapper's launches by route."""
    return {name: dict(fn.routes) for name, fn in ROUTED.items()}


def counts(**launches: int) -> dict[str, int]:
    """Every counter at 0 but those named: what a path should read."""
    return {**dict.fromkeys(COUNTERS, 0), **launches}


def check_lm_launches(phase: str, launches: dict[str, int],
                      routes: dict[str, dict[str, int]], fwd: int,
                      bwd: int = 0, wgmma_fwd: int = 0,
                      wgmma_bwd: int = 0, cc_bwd: int = 0) -> None:
    """An LM path: no DLRM kernel; at least ``fwd`` flash attention
    forward launches (its layers times its calls) and ``bwd`` backward
    launches (two a backward call on either route); at least ``wgmma_fwd``
    and ``wgmma_bwd`` of them on the wgmma route (its bf16 calls) and
    ``cc_bwd`` backward launches on the cuda_cores route (its float32
    calls)."""
    print(f"[{phase}] launches of the port's kernels over the phase: "
          f"{launches}; by route {routes}; at least {fwd} attention forward "
          f"and {bwd} backward launches expected (two a backward call), "
          f"{wgmma_fwd} and {wgmma_bwd} of them on the wgmma route, "
          f"{cc_bwd} backward ones on the cuda_cores route")
    if any(launches[k] for k in DLRM_KERNELS):
        raise AssertionError(f"the {phase} path launched a DLRM kernel")
    if launches["flash_attention_fwd"] < fwd or \
            launches["flash_attention_bwd"] < bwd:
        raise AssertionError(f"the {phase} path did not run attention "
                             f"through the kernel: {launches}")
    if routes["flash_attention_fwd"]["wgmma"] < wgmma_fwd or \
            routes["flash_attention_bwd"]["wgmma"] < wgmma_bwd:
        raise AssertionError(f"the {phase} path's bf16 attention did not "
                             f"run on the wgmma route: {routes}")
    if routes["flash_attention_bwd"]["cuda_cores"] < cc_bwd:
        raise AssertionError(f"the {phase} path's float32 backward did not "
                             f"run on the cuda_cores route: {routes}")


def phase_retrieval(res: serve_mod.ServeResult) -> dict:
    """retrieval_score on the served dlrm-rm2 model: 1 user x 1M candidates,
    launch counts, scores against the plain-routed version, time per
    call."""
    p, cfg = res.params, res.cfg
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"dense": torch.randn(1, cfg.n_dense, generator=gen,
                                  device="cuda"),
             "indices": res.inputs[0]["indices"][:1],
             "candidates": torch.randint(0, cfg.n_rows[-1], (N_CANDIDATES,),
                                         generator=gen, device="cuda",
                                         dtype=torch.int32)}
    with torch.inference_mode():
        reset_counts()
        scores = dlrm.retrieval_score(p, batch, cfg)
        torch.cuda.synchronize()
        launches = read_counts()
        want = counts(recflash_sls_grouped=1, dot_interaction_fused=1,
                      recflash_sls=1)
        print(f"[retrieval] 1 user x {N_CANDIDATES} candidates, "
              f"{cfg.n_tables} tables x {cfg.n_rows[0]} rows x "
              f"{cfg.embed_dim}: launches {launches}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if launches != want:
            raise AssertionError(f"retrieval launch counts {launches} != "
                                 f"{want}")
        if scores.shape != (N_CANDIDATES,) or not torch.isfinite(
                scores).all():
            raise AssertionError("retrieval scores are not finite or "
                                 "misshapen")
        err = compare("retrieval scores vs the plain-routed version",
                      scores, dlrm.retrieval_score(p, batch, cfg, plain=True),
                      LOGIT_TOL)
        ms = time_ms(lambda: dlrm.retrieval_score(p, batch, cfg), [()],
                     reps=5, launches=24)
        plain_ms = time_ms(lambda: dlrm.retrieval_score(p, batch, cfg,
                                                        plain=True),
                           [()], reps=2, launches=300)
    print(f"[retrieval] {ms:.3f} ms per call on the card (plain-routed "
          f"{plain_ms:.3f} ms), {N_CANDIDATES / ms / 1e3:.1f} M "
          f"candidates/s")
    return dict(launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms)


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


def time_train_shapes(p: dict, cfg) -> dict[str, dict[str, float]]:
    """The grouped SLS and the fused interaction at the training batch
    (``launch/train.py``'s batch 0 at batch 4096, through the served
    model's remap), and their Functions' backwards (plain PyTorch): device
    ms per call."""
    b = TRAIN["batch"]
    tb, rows = generate_sls_batch(cfg.n_tables, cfg.n_rows[0], cfg.lookups,
                                  b, k=0.0, seed=0)
    idx = torch.from_numpy(rows.reshape(b, cfg.n_tables, cfg.lookups)
                           .astype(np.int32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = mlp(p["bot"], torch.randn(b, cfg.n_dense, generator=gen,
                                  device="cuda"))
    bags = dlrm.bags(p, idx)
    g_bags = torch.randn(bags.shape, generator=gen, device="cuda")
    g_feat = torch.randn(b, cfg.top_in, generator=gen, device="cuda")
    n_rows = [t.shape[0] for t in p["tables"]]
    out = {
        "recflash_sls_grouped": dict(
            train_ms=time_ms(recflash_sls_grouped,
                             [(p["tables"], p["hot_sizes"], idx, p["rank_of"],
                               p["sls_desc"])], reps=20),
            backward_ms=time_ms(recflash_sls_grouped_backward,
                                [(g_bags, n_rows, idx, p["rank_of"])],
                                reps=3, launches=6 * cfg.n_tables)),
        "dot_interaction_fused": dict(
            train_ms=time_ms(dot_interaction_fused, [(x, bags)], reps=50),
            backward_ms=time_ms(dot_interaction_fused_backward,
                                [(g_feat, x, bags)], reps=20, launches=12)),
    }
    for name, t in out.items():
        print(f"[time] {name} at the training batch ({b}): forward "
              f"{t['train_ms'] * 1e3:.2f} us, its Function's backward "
              f"(plain PyTorch) {t['backward_ms'] * 1e3:.2f} us")
    return out


def phase_time(res: serve_mod.ServeResult, launches: dict[str, int],
               err: dict[str, float]) -> list[dict]:
    """Entry, plain version and yardstick times at the main path's inputs;
    the serve step per batch."""
    p, cfg = res.params, res.cfg
    n_t, dim, lk = cfg.n_tables, cfg.embed_dim, cfg.lookups
    # every batch of the serve run, and every (batch, table) of it, with its
    # real ids and ranks
    grouped_calls, bag_calls, sls_calls, lib_calls = [], [], [], []
    for inp in res.inputs:
        idx = inp["indices"]
        grouped_calls.append((p["tables"], p["hot_sizes"], idx, p["rank_of"],
                              p["sls_desc"]))
        bag_calls.append((p, idx))
        for t in range(n_t):
            ranks = lookup(p["rank_of"][t], idx[:, t, :])
            stored, h = p["tables"][t], p["hot_sizes"][t]
            sls_calls.append((stored[:h], stored[h:], ranks))
            lib_calls.append((ranks, stored))
    n_b = len(grouped_calls)
    g_bytes, t_bytes = sls_bytes(p, res.inputs)
    flops = SERVE["batch"] * lk * dim
    g_bound, g_by = bound_ms(g_bytes, n_t * flops)
    sls_bound, sls_by = bound_ms(t_bytes, flops)
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
    train_shapes = time_train_shapes(p, cfg)
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
                              launches=4 * n_t + lk + 2),
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
                                  launches=lk + 4),
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
          f"run: mean {g_bytes / 1e6:.3f} MB of unique rows, unique "
          f"rank_of entries, indices and output per batch; per-table "
          f"launches: mean {t_bytes / 1e6:.3f} MB")
    print(f"[time] torch.bmm alone on the interaction's z ({b}, {t}, {dim}) "
          f"f32: {bmm_ms * 1e3:.2f} us")
    for r in records:
        r.update(train_shapes[r["entry"]])
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


def _median(xs: list[float]) -> float:
    return sorted(xs)[len(xs) // 2]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64 (0 where both are 0)."""
    err = float(torch.linalg.vector_norm(a.double() - b.double()))
    ref = float(torch.linalg.vector_norm(b.double()))
    return err / ref if ref else (0.0 if err == 0 else float("inf"))


def check_tensors(label: str, got, want, limit: float = GRAD_REL_L2
                  ) -> float:
    """Each tensor of ``got`` against its counterpart in ``want``: finite,
    and ||got - want|| <= limit * ||want|| (a zero ``want`` must be
    matched exactly). Returns the largest relative error."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        rel = _rel(a, b)
        worst = max(worst, rel)
        if rel > limit or not torch.isfinite(a).all():
            raise AssertionError(f"{label}: tensor {i} {tuple(a.shape)} "
                                 f"differs: relative error {rel:.3e} > "
                                 f"{limit}")
    print(f"[check] {label}: {len(got)} tensors, largest relative error "
          f"||got - want|| / ||want|| {worst:.3e} (limit {limit}) ok")
    return worst


def phase_train() -> dict:
    """launch/train.py's DLRM pipeline at dlrm-rm2's width through
    TrainLoop, one checkpoint; launches per step, losses, step breakdown,
    memory, checkpoint bytes and seconds; one step's gradients against the
    plain-routed autograd."""
    cfg = configs.DLRM_RM2
    args = argparse.Namespace(**TRAIN)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, loss_fn, batch_fn = train_mod._dlrm_pipeline(
        args, remap=True, cfg=cfg)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    step_fn = train_mod.make_step(opt, loss_fn)
    batch_s, step_s, losses = [], [], []

    def timed_batch(step):
        t = time.perf_counter()
        batch = batch_fn(step)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t)
        return batch

    step_peak = []

    def timed_step(state, batch):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_peak.append(torch.cuda.max_memory_allocated() / 2**30)
        losses.append(float(out[2]))
        return out

    n_param = sum(x.numel() for x in tree.leaves(params))
    print(f"[train] {cfg.name}: {cfg.n_tables} tables x {cfg.n_rows[0]} rows "
          f"x {cfg.embed_dim} f32, {n_param / 1e6:.1f}M parameters, remap "
          f"on, batch {TRAIN['batch']}; set-up (init, sweep, remap) "
          f"{t_setup:.2f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, its peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # the loop gets the only reference to the initial state (a list popped
    # into the call), so that the initial tables die after the first step:
    # a name held here would keep 6.7 GB alive for the whole loop
    init = [(params, opt.init(params),
             torch.zeros((), device=TRAIN["device"]))]
    del params
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(ckpt_dir).free
        need = sum(x.numel() * x.element_size() for x in tree.leaves(init))
        print(f"[train] checkpoint directory {ckpt_dir}: {free / 1e9:.1f} "
              f"GB free, the state is {need / 1e9:.2f} GB")
        loop = TrainLoop(cfg=LoopConfig(total_steps=TRAIN_STEPS,
                                        ckpt_dir=ckpt_dir,
                                        ckpt_every=TRAIN_STEPS, keep_ckpts=1),
                         step_fn=timed_step, batch_fn=timed_batch)
        reset_counts()
        t0 = time.perf_counter()
        state = loop.run(init.pop())
        t_run = time.perf_counter() - t0
        launches = read_counts()
        peak = max(step_peak) * 2**30
        npz = Path(ckpt_dir) / f"step_{TRAIN_STEPS:08d}" / "arrays.npz"
        ckpt_bytes = npz.stat().st_size
        if checkpoint.latest_step(ckpt_dir) != TRAIN_STEPS:
            raise AssertionError("the loop's checkpoint is missing")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    t_ckpt = t_run - sum(step_s) - sum(batch_s)
    warm = step_s[1:]
    print(f"[train] {TRAIN_STEPS} steps: losses "
          f"{[round(x, 6) for x in losses]}")
    print(f"[train] step (forward, backward, optimizer; synchronised): "
          f"first {step_s[0] * 1e3:.1f} ms, warm median "
          f"{_median(warm) * 1e3:.1f} ms, min {min(warm) * 1e3:.1f} ms; "
          f"batch_fn (host) median {_median(batch_s):.3f} s; launches "
          f"{launches}")
    print(f"[train] peak device memory {peak / 2**30:.2f} GiB; in each step "
          f"{[round(x, 2) for x in step_peak]} GiB")
    print(f"[train] checkpoint {ckpt_bytes / 1e9:.3f} GB of .npz in "
          f"{t_ckpt:.2f} s (the loop's time less its steps and batches)")
    want = counts(recflash_sls_grouped=TRAIN_STEPS,
                  dot_interaction_fused=TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses} are not finite")

    params, opt_state, _ = state
    batch = batch_fn(TRAIN_STEPS)
    parts: dict[str, list[float]] = {"forward": [], "backward": [],
                                     "optimizer": []}
    peaks: dict[str, float] = {}

    def mark(part: str, t_begin: float) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        parts[part].append(t - t_begin)
        peaks[part] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        return t

    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
        loss = loss_fn(tree.unflatten(params, leaves), batch)
        t = mark("forward", t)
        grads = torch.autograd.grad(loss, leaves)
        t = mark("backward", t)
        new = opt.update(tree.unflatten(params, list(grads)), opt_state,
                         params)
        mark("optimizer", t)
        del leaves, loss, grads, new
    print("[train] step breakdown, median of 3 (host clock, synchronised): "
          + ", ".join(f"{k} {_median(v) * 1e3:.2f} ms"
                      for k, v in parts.items())
          + "; peak device memory in each: "
          + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items()))

    leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
    p = tree.unflatten(params, leaves)
    reset_counts()
    loss = loss_fn(p, batch)
    grads = torch.autograd.grad(loss, leaves)
    if read_counts()["recflash_sls_grouped"] != 1:
        raise AssertionError("the gradient check did not run the kernels")
    plain = loss_fn(p, batch, plain=True)
    compare("train loss through the Functions vs the plain-routed loss",
            loss.detach(), plain.detach(), LOSS_TOL)
    plain_grads = torch.autograd.grad(plain, leaves)
    grad_err = check_tensors("train gradients through the Functions vs "
                             "autograd of the plain-routed forward", grads,
                             plain_grads)
    del p, leaves, loss, plain
    # the float64 plain-routed gradient at the same parameters: how far each
    # route is from exact (read, not held: the check above holds them)
    paths = [path for path, _ in tree.flatten_with_path(params)]
    leaves64 = [x.detach().double().requires_grad_()
                for x in tree.leaves(params)]
    batch64 = {**batch, "dense": batch["dense"].double(),
               "labels": batch["labels"].double()}
    exact = torch.autograd.grad(loss_fn(tree.unflatten(params, leaves64),
                                        batch64, plain=True), leaves64)
    del leaves64
    far = {route: [_rel(g, e) for g, e in zip(gs, exact, strict=True)]
           for route, gs in (("kernel", grads), ("plain", plain_grads))}
    del exact, plain_grads
    worst = {route: max(range(len(paths)), key=e.__getitem__)
             for route, e in far.items()}
    print("[train] against the float64 plain-routed gradient, largest "
          "relative error ||g - g64|| / ||g64||: "
          + "; ".join(f"{route} route {far[route][i]:.3e} at {paths[i]} "
                      f"(the other route there {far[other][i]:.3e})"
                      for route, other in (("kernel", "plain"),
                                           ("plain", "kernel"))
                      for i in (worst[route],)))
    return dict(launches=launches, step_ms=_median(warm) * 1e3,
                peak_gib=peak / 2**30, ckpt_gb=ckpt_bytes / 1e9,
                ckpt_s=t_ckpt, grad_err=grad_err,
                parts_ms={k: _median(v) * 1e3 for k, v in parts.items()})


def phase_resume() -> None:
    """At small_dlrm on the card: a TrainLoop crashed after 7 steps and
    resumed to step 20 against an uninterrupted one (the reference's
    tests/test_runtime.py case). index_add_ adds with atomics on the card,
    so the two runs agree to rounding (``check_tensors``)."""
    args = argparse.Namespace(**{**TRAIN, "batch": 64})

    def run(ckpt_dir, fail_after=None):
        params, opt, loss_fn, batch_fn = train_mod._dlrm_pipeline(args, True)
        loop = TrainLoop(cfg=LoopConfig(total_steps=20, ckpt_dir=ckpt_dir,
                                        ckpt_every=5),
                         step_fn=train_mod.make_step(opt, loss_fn),
                         batch_fn=batch_fn, fail_after_steps=fail_after)
        return loop.run((params, opt.init(params),
                         torch.zeros((), device=TRAIN["device"])))

    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        ref = run(os.path.join(root, "ref"))
        crashy = os.path.join(root, "crashy")
        try:
            run(crashy, fail_after=7)
        except StepFailure as e:
            print(f"[resume] {e}; newest checkpoint: step "
                  f"{checkpoint.latest_step(crashy)}")
        else:
            raise AssertionError("the injected failure did not fire")
        out = run(crashy)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    worst = check_tensors("small_dlrm state after crash at 7 and resume to "
                          "20 vs an uninterrupted run", tree.leaves(out),
                          tree.leaves(ref))
    same = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(out), tree.leaves(ref), strict=True))
    print(f"[resume] final loss {float(out[2]):.6f} (uninterrupted "
          f"{float(ref[2]):.6f}); bitwise equal: {same}; max abs diff "
          f"{worst:.3e}")


def phase_cli() -> None:
    """``python -m repro_torch.launch.train`` on the card as the
    reference's tests/test_launch.py drives ``repro.launch.train``: 30
    steps, then 40 on the same checkpoint directory, which resumes at 30."""
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    try:
        outs = []
        for steps in (30, 40):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--model",
                 "dlrm", "--steps", str(steps), "--batch", "64",
                 "--ckpt-every", "10", "--ckpt-dir", ckpt_dir], env=env,
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            for line in r.stdout.splitlines():
                print(f"[cli --steps {steps}] {line}")
            if r.returncode:
                raise AssertionError(f"the training CLI failed:\n"
                                     f"{r.stderr[-3000:]}")
            print(f"[cli --steps {steps}] {time.perf_counter() - t0:.1f} s "
                  f"in all")
            outs.append(r.stdout)
        resumed_at = checkpoint.latest_step(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not ("final loss" in outs[0] and outs[0].count("\nstep ") == 3
            and "final loss" in outs[1] and outs[1].count("\nstep ") == 1
            and resumed_at == 40):
        raise AssertionError("the CLI did not train 30 steps and then resume "
                             "for 10 more")


def _steps_ms(fn, reps: int = 20) -> float:
    """Median host ms of ``fn()`` ending in a synchronise, after a warm
    call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * _median(times)


def phase_sharded(served: dict, card: str) -> dict:
    """The distributed embedding over NCCL on a (1, 1) mesh: dlrm-rm2 at
    full width, remap on (the train pipeline's init and offline sweep);
    the mesh forwards and a 2D training step against the single-device
    path; compressed_psum; a checkpoint restored onto shardings."""
    import torch.distributed as dist
    cfg = configs.DLRM_RM2
    pg_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dmesh.init("cuda", rank=0, world_size=1,
               store=dist.FileStore(os.path.join(pg_dir, "store"), 1))
    try:
        mesh = dmesh.make_mesh((1, 1), ("data", "model"), "cuda")
        print(f"[sharded] process group: {dist.get_backend()}, world size "
              f"{dist.get_world_size()}; mesh {mesh.shape} on {mesh.device}")
        t0 = time.perf_counter()
        params = dlrm.init(TRAIN["seed"], cfg, device="cuda")
        rank_of, hot = train_mod.remap_tables(params, cfg, TRAIN["seed"])
        single = dlrm.add_remap(params, rank_of, hot)
        torch.cuda.synchronize()
        print(f"[sharded] {cfg.name}: {cfg.n_tables} tables x "
              f"{cfg.n_rows[0]} rows x {cfg.embed_dim} f32, remap on; set-up "
              f"{time.perf_counter() - t0:.2f} s")
        # this rank's blocks: on a (1, 1) mesh each is the whole tensor (a
        # view, no copy); rank_of shards as its table's rows
        specs = {"1d": make_param_specs(params, configs.PARAM_RULES),
                 "2d": make_param_specs(params, configs.PARAM_RULES_2D)}
        blocks = {k: {**tree.tree_map(
            lambda x, s: NamedSharding(mesh, s).shard(x), params, sp),
            "rank_of": [NamedSharding(mesh, P(("model", "data") if k == "2d"
                                            else "model")).shard(r)
                        for r in rank_of]} for k, sp in specs.items()}
        ways = {"masked-psum (two-phase)": ("1d", {}),
                "hybrid": ("1d", dict(hybrid=True)),
                "hybrid + table_2d": ("2d", dict(hybrid=True,
                                                 table_2d=True))}
        b = TRAIN["batch"]
        tbatch = train_mod.make_batch_fn(cfg, b, TRAIN["seed"],
                                         torch.device("cuda"))(0)

        def mesh_loss(p, batch):
            return dlrm.loss({**p, "rank_of": blocks["2d"]["rank_of"]},
                             batch, cfg, mesh, hybrid=True, table_2d=True)

        def mesh_grads():
            leaves = [x.detach().requires_grad_()
                      for x in tree.leaves(params)]
            loss = mesh_loss(tree.unflatten(params, leaves), tbatch)
            grads = sync_grads(mesh, tree.unflatten(params, list(
                torch.autograd.grad(loss, leaves))), specs["2d"])
            return loss.detach(), tree.leaves(grads)

        # the main path of this phase, counted: three mesh forwards of the
        # served batch and one 2D training step
        reset_counts()
        mesh.calls.clear()
        outs, per_way = {}, {}
        with torch.inference_mode():
            for way, (k, kw) in ways.items():
                before = dict(mesh.calls)
                fused0 = dot_interaction_fused.launches
                outs[way] = dlrm.forward(blocks[k], served, cfg, mesh, **kw)
                per_way[way] = dict(
                    collectives={c: n - before.get(c, 0)
                                 for c, n in mesh.calls.items()},
                    fused=dot_interaction_fused.launches - fused0)
        before = dict(mesh.calls)
        fused0 = dot_interaction_fused.launches
        loss, grads = mesh_grads()
        torch.cuda.synchronize()
        train_calls = {c: n - before.get(c, 0) for c, n in mesh.calls.items()}
        train_fused = dot_interaction_fused.launches - fused0
        launches = read_counts()
        want = counts(dot_interaction_fused=4)
        print(f"[sharded] launches over the phase's path (3 mesh forwards, "
              f"1 training step): {launches}")
        if launches != want:
            raise AssertionError(f"sharded launch counts {launches} != "
                                 f"{want}")
        for way, info in per_way.items():
            print(f"[sharded] forward {way}: NCCL collectives per step "
                  f"{info['collectives']}, fused-interaction launches "
                  f"{info['fused']}")
        print(f"[sharded] training step (hybrid + table_2d, batch {b}): NCCL "
              f"collectives per step (forward, backward, gradient sync) "
              f"{train_calls}, fused-interaction launches {train_fused}")

        # against the single-device kernel path (these launches not
        # counted above)
        with torch.inference_mode():
            want_logits = dlrm.forward(single, served, cfg)
        errs = {way: compare(f"sharded forward {way} vs the single-device "
                             f"kernel forward (batch {served['dense'].shape[0]})",
                             out, want_logits, LOGIT_TOL)
                for way, out in outs.items()}
        leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
        ref_loss = dlrm.loss(dlrm.add_remap(tree.unflatten(params, leaves),
                                            rank_of, hot), tbatch, cfg)
        ref_grads = torch.autograd.grad(ref_loss, leaves)
        compare("sharded 2D training loss vs the single-device step's",
                loss, ref_loss.detach(), LOSS_TOL)
        grad_err = check_tensors("sharded 2D training gradients (after "
                                 "sync_grads) vs the single-device step's",
                                 grads, ref_grads)
        del leaves, ref_grads

        # compressed_psum on a real gradient leaf: the first table's
        comp_leaf = grads[[path for path, _ in tree.flatten_with_path(
            params)].index("['tables'][0]")]
        out, st = compressed_psum(comp_leaf, "data",
                                  CompressionState.zeros_like(comp_leaf), 8,
                                  mesh=mesh)
        scale = torch.clamp_min(comp_leaf.abs().max() / 127.0, 1e-20)
        deq = torch.clamp(torch.round(comp_leaf / scale), -127, 127) * scale
        exact = dict(rtol=0.0, atol=0.0)
        compare(f"compressed_psum (8 bits, data axis of 1) of a "
                f"{tuple(comp_leaf.shape)} table gradient vs its own "
                f"quantise-dequantise", out, deq, exact)
        compare("compressed_psum residual vs the gradient less its "
                "dequantised payload", st.residual, comp_leaf - deq, exact)
        del grads, out, st, deq, comp_leaf

        # warm steps: mesh forwards beside the single-device forward, the
        # mesh training step's forward and backward beside the
        # single-device one's
        with torch.inference_mode():
            fwd_ms = {way: _steps_ms(lambda k=k, kw=kw: dlrm.forward(
                blocks[k], served, cfg, mesh, **kw)) for way, (k, kw)
                      in ways.items()}
            fwd_ms["single device (kernels)"] = _steps_ms(
                lambda: dlrm.forward(single, served, cfg))

        def single_grads():
            lv = [x.detach().requires_grad_() for x in tree.leaves(params)]
            loss = dlrm.loss(dlrm.add_remap(tree.unflatten(params, lv),
                                            rank_of, hot), tbatch, cfg)
            return torch.autograd.grad(loss, lv)

        step_ms = {"hybrid + table_2d": _steps_ms(mesh_grads, reps=3),
                   "single device (kernels)": _steps_ms(single_grads,
                                                        reps=3)}
        # one collective alone, on a group of one rank: 52 back to back at
        # a batch-64 bag's shape (the masked-psum forward's count)
        from repro_torch.distributed.mesh import (all_gather, psum,
                                                  psum_scatter)
        x = torch.randn(64, cfg.embed_dim, device="cuda")
        one_ms = {name: _steps_ms(lambda f=f: [f(x, mesh, "model")
                                               for _ in range(52)],
                                  reps=5) / 52
                  for name, f in (("all_reduce", psum),
                                  ("reduce_scatter", psum_scatter),
                                  ("all_gather", all_gather))}
        print(f"[sharded] one NCCL collective on a group of one, (64, "
              f"{cfg.embed_dim}) f32, 52 back to back: "
              + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in one_ms.items())
              + f" per call on {card}")
        for way, ms in fwd_ms.items():
            print(f"[sharded] forward {way}, warm, batch "
                  f"{served['dense'].shape[0]}: median {ms:.3f} ms on {card}")
        for way, ms in step_ms.items():
            print(f"[sharded] training forward + backward {way}, warm, batch "
                  f"{b}: median {ms:.1f} ms on {card}")
        del blocks, single, params, rank_of

        # a small_dlrm checkpoint (TrainLoop's state) onto shardings
        args = argparse.Namespace(**{**TRAIN, "batch": 64})
        p_small, opt, _, _ = train_mod._dlrm_pipeline(args, True)
        state = (p_small, opt.init(p_small), torch.zeros((), device="cuda"))
        sh = tree.tree_map(lambda s: NamedSharding(mesh, s), (
            make_param_specs(state[0], configs.PARAM_RULES_2D),
            make_param_specs(state[1], configs.OPT_RULES_2D), P()))
        ck_dir = tempfile.mkdtemp(prefix="chip_smoke_shard_ckpt_")
        try:
            checkpoint.save(ck_dir, 1, state)
            got = checkpoint.restore(ck_dir, 1, state, sh)
            checkpoint.save(ck_dir, 2, got, shardings=sh)
            again = checkpoint.restore(ck_dir, 2, state, sh)
        finally:
            shutil.rmtree(ck_dir, ignore_errors=True)
        n_leaves = len(tree.leaves(state))
        if not all(a.device.type == "cuda" and torch.equal(a, b) and
                   torch.equal(c, b) for a, b, c in zip(
                       tree.leaves(got), tree.leaves(state),
                       tree.leaves(again), strict=True)):
            raise AssertionError("the checkpoint restored onto shardings "
                                 "differs from the saved state")
        print(f"[sharded] small_dlrm TrainLoop state ({n_leaves} leaves) "
              f"saved, restored onto 2D shardings on the card, saved from "
              f"them and restored again: equal")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)
    return dict(launches=launches, fwd_ms=fwd_ms, step_ms=step_ms,
                one_ms=one_ms, errs=errs, grad_err=grad_err)


def call_ms(fn, reps: int = 5) -> float:
    """Milliseconds per call of ``fn()`` between two CUDA events around
    ``reps`` back-to-back calls, after a warm call: the card's view of a
    call, host issue included where the host is slower than the card."""
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


def _grads(fn, params) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The loss ``fn(params)`` and its gradient with respect to every leaf
    of ``params``."""
    leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
    loss = fn(tree.unflatten(params, leaves))
    # a leaf the loss does not reach (a router bias) gets zeros, as
    # jax.grad gives it
    return loss.detach(), list(torch.autograd.grad(loss, leaves,
                                                   materialize_grads=True))


def _to(tree_, device):
    return tree.unflatten(tree_, [x.to(device) for x in tree.leaves(tree_)])


def _join_softmax_biases(params, grads: list[torch.Tensor],
                         biases: tuple[str, ...]) -> list[torch.Tensor]:
    """``grads`` (in the leaf order of ``params``), each alone, except that
    the gradient of each bias path in ``biases`` is joined (flattened) to
    that of its layer's ``w``."""
    paths = [path for path, _ in tree.flatten_with_path(params)]
    by_path = dict(zip(paths, grads, strict=True))
    out = []
    for path in paths:
        if path in biases:
            continue
        g = by_path[path]
        bias = path[:-len("['w']")] + "['b']"
        if path.endswith("['w']") and bias in biases:
            g = torch.cat([g.reshape(-1), by_path[bias].reshape(-1)])
        out.append(g)
    return out


def phase_bf16(res: serve_mod.ServeResult, card: str) -> dict:
    """dlrm-rm2 at full width in bf16, remap on: the served model cast to
    bf16. The three kernel entries in bf16 against their plain versions at
    the serve shapes; then the path, counted: the serve lane's batches
    (bf16 dense features), one retrieval of 1 x 1M and one training step at
    batch 4096; checked against the plain route and timed."""
    cfg, p32 = res.cfg, res.params
    bf = torch.bfloat16
    t0 = time.perf_counter()
    trainable = {k: tree.tree_map(lambda x: x.to(bf), p32[k])
                 for k in ("tables", "bot", "top")}
    rank_of, hot = p32["rank_of"], p32["hot_sizes"]
    p = dlrm.add_remap(trainable, rank_of, hot)
    torch.cuda.synchronize()
    table_gb = sum(t.numel() * t.element_size() for t in p["tables"]) / 1e9
    print(f"[bf16] {cfg.name}: {cfg.n_tables} tables x {cfg.n_rows[0]} rows "
          f"x {cfg.embed_dim} bf16 ({table_gb:.2f} GB) and bf16 MLPs on the "
          f"card, remap on; cast from the served f32 model in "
          f"{time.perf_counter() - t0:.2f} s")
    inputs = [{**inp, "dense": inp["dense"].to(bf)} for inp in res.inputs]
    n_b = len(inputs)

    # each entry in bf16 against its plain version at the serve shapes
    idx = inputs[0]["indices"]
    err = {}
    got = recflash_sls_grouped(p["tables"], hot, idx, rank_of, p["sls_desc"])
    err["recflash_sls_grouped"] = compare(
        f"bf16 recflash_sls_grouped, serve batch 0 ({cfg.n_tables} tables, "
        f"B={idx.shape[0]}, L={cfg.lookups}, rank_of)", got,
        ops.sls_grouped_ref(p["tables"], hot, idx, rank_of), BF16_KERNEL_TOL)
    st, h = p["tables"][0], hot[0]
    ranks0 = lookup(rank_of[0], idx[:, 0, :])
    got1 = recflash_sls(st[:h], st[h:], ranks0)
    err["recflash_sls"] = compare(
        f"bf16 recflash_sls, serve batch 0 table 0 (H={h})", got1,
        ops.sls_ref(st[:h], st[h:], ranks0), BF16_KERNEL_TOL)
    x = mlp(p["bot"], inputs[0]["dense"])
    bags = dlrm.bags(p, idx)
    got2 = dot_interaction_fused(x, bags)
    err["dot_interaction_fused"] = compare(
        f"bf16 dot_interaction_fused, serve batch 0 {tuple(bags.shape)}",
        got2, ops.fused_ref(x, bags), BF16_KERNEL_TOL)
    if not got.dtype == got1.dtype == got2.dtype == bags.dtype == bf:
        raise AssertionError("a bf16 entry did not return bf16")

    # the path, counted: serve batches, one retrieval, one training step
    gen = torch.Generator(device="cuda").manual_seed(3)
    rbatch = {"dense": torch.randn(1, cfg.n_dense, generator=gen,
                                   device="cuda").to(bf),
              "indices": idx[:1],
              "candidates": torch.randint(0, cfg.n_rows[-1], (N_CANDIDATES,),
                                          generator=gen, device="cuda",
                                          dtype=torch.int32)}
    tb = train_mod.make_batch_fn(cfg, TRAIN["batch"], TRAIN["seed"],
                                 torch.device("cuda"))(0)
    tb = {**tb, "dense": tb["dense"].to(bf)}
    opt = optim.partitioned(
        lambda ks: "table" if "tables" in ks else "dense",
        {"table": optim.adagrad(TRAIN["lr_table"], rowwise=True),
         "dense": optim.adamw(TRAIN["lr"])})

    def loss_fn(q, batch, plain=False):
        return dlrm.loss(dlrm.add_remap(q, rank_of, hot), batch, cfg,
                         plain=plain)

    step_fn = train_mod.make_step(opt, loss_fn)
    state0 = (trainable, opt.init(trainable), torch.zeros((), device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    graphs0 = (dlrm.forward.graph_captures, dlrm.forward.graph_replays)
    with torch.inference_mode():
        logits = [dlrm.forward(p, inp, cfg) for inp in inputs]
        scores = dlrm.retrieval_score(p, rbatch, cfg)
    state1 = step_fn(state0, tb)
    torch.cuda.synchronize()
    launches = read_counts()
    graphs = (dlrm.forward.graph_captures - graphs0[0],
              dlrm.forward.graph_replays - graphs0[1])
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the serve batches replay a CUDA graph but a bucket's first (eager)
    buckets = len({dlrm.graph_bucket(inp["dense"].shape[0])
                   for inp in inputs})
    want = counts(recflash_sls_grouped=buckets + 2,
                  dot_interaction_fused=buckets + 2, recflash_sls=1)
    print(f"[bf16] launches over the path ({n_b} serve batches, 1 retrieval, "
          f"1 training step): {launches}; serve graph captures and replays "
          f"{graphs}; peak device memory {peak:.2f} GiB")
    if launches != want or graphs != (buckets, n_b - buckets):
        raise AssertionError(f"bf16 launch counts {launches} != {want}, or "
                             f"graph captures and replays {graphs}")
    if not all(lg.dtype == bf and torch.isfinite(lg.float()).all()
               for lg in logits + [scores]):
        raise AssertionError("bf16 logits are not bf16 and finite")
    errs = [compare(f"bf16 serve batch {i} logits vs the plain-routed "
                    f"forward", lg, dlrm.forward(p, inp, cfg, plain=True),
                    BF16_TOL) for i, (lg, inp) in enumerate(
                        zip(logits, inputs, strict=True))]
    r_err = compare(f"bf16 retrieval scores (1 x {N_CANDIDATES}) vs the "
                    f"plain-routed version", scores,
                    dlrm.retrieval_score(p, rbatch, cfg, plain=True),
                    BF16_TOL)
    new_params, new_state, step_loss = state1
    acc = sorted({str(x.dtype)[6:] for x in tree.leaves(new_state)
                  if x.is_floating_point()})
    kinds = sorted({str(x.dtype)[6:] for x in tree.leaves(new_params)})
    print(f"[bf16] training step at batch {TRAIN['batch']}: loss "
          f"{float(step_loss):.6f}; params after the step {kinds}; "
          f"optimizer state (row-wise adagrad accumulators, AdamW moments) "
          f"{acc}")
    if not np.isfinite(float(step_loss)) or kinds != ["bfloat16"] or \
            acc != ["float32"]:
        raise AssertionError("the bf16 training step's loss, params or "
                             "optimizer state are wrong")
    del state1, new_params, new_state
    loss_k, g_k = _grads(lambda q: loss_fn(q, tb), trainable)
    loss_p, g_p = _grads(lambda q: loss_fn(q, tb, plain=True), trainable)
    compare("bf16 train loss through the Functions vs the plain-routed "
            "loss", loss_k, loss_p, BF16_TOL)
    if not all(g.dtype == bf for g in g_k):
        raise AssertionError("a bf16 parameter's gradient is not bf16")
    grad_err = check_tensors("bf16 train gradients through the Functions vs "
                             "autograd of the plain-routed forward", g_k,
                             g_p, BF16_GRAD_REL_L2)
    del g_k, g_p

    # times, CUDA events
    grouped_calls = [(p["tables"], hot, inp["indices"], rank_of,
                      p["sls_desc"]) for inp in inputs]
    sls_calls, lib_calls = [], []
    for t in range(cfg.n_tables):
        r = lookup(rank_of[t], idx[:, t, :])
        sls_calls.append((p["tables"][t][:hot[t]], p["tables"][t][hot[t]:],
                          r))
        lib_calls.append((r, p["tables"][t]))
    fused_calls = [(mlp(p["bot"], inp["dense"]), dlrm.bags(p, inp["indices"]))
                   for inp in inputs]
    b, t_v, dim, lk = idx.shape[0], cfg.n_vectors, cfg.embed_dim, cfg.lookups
    g_bytes, t_bytes = sls_bytes(p, inputs)
    g_bound, g_by = bound_ms(g_bytes, cfg.n_tables * b * lk * dim,
                             BF16_FLOPS)
    s_bound, s_by = bound_ms(t_bytes, b * lk * dim, BF16_FLOPS)
    n_tri = t_v * (t_v - 1) // 2
    f_bound, f_by = bound_ms(b * t_v * dim * 2 + b * (dim + n_tri) * 2,
                             2 * b * n_tri * dim, BF16_FLOPS)
    kernels = {
        "recflash_sls_grouped": dict(
            ms=time_ms(recflash_sls_grouped, grouped_calls, reps=20),
            plain_ms=time_ms(ops.sls_grouped_ref,
                             [c[:4] for c in grouped_calls], reps=1,
                             launches=4 * cfg.n_tables + lk + 2),
            bound_ms=g_bound, bound_by=g_by, library_ms=None,
            max_abs_err=err["recflash_sls_grouped"]),
        "recflash_sls": dict(
            ms=time_ms(recflash_sls, sls_calls),
            plain_ms=time_ms(ops.sls_ref, sls_calls, reps=1,
                             launches=lk + 4),
            bound_ms=s_bound, bound_by=s_by,
            library_ms=time_ms(
                lambda i, w: F.embedding_bag(i, w, mode="sum"), lib_calls,
                launches=6),
            max_abs_err=err["recflash_sls"]),
        "dot_interaction_fused": dict(
            ms=time_ms(dot_interaction_fused, fused_calls, reps=50),
            plain_ms=time_ms(ops.fused_ref, fused_calls, reps=50,
                             launches=10),
            bound_ms=f_bound, bound_by=f_by, library_ms=None,
            max_abs_err=err["dot_interaction_fused"]),
    }
    for name, k in kernels.items():
        lib = ("" if k["library_ms"] is None else
               f", library {k['library_ms'] * 1e3:.2f} us")
        print(f"[bf16] {name}: {k['ms'] * 1e3:.2f} us/launch (plain "
              f"{k['plain_ms'] * 1e3:.2f} us{lib}, bound "
              f"{k['bound_ms'] * 1e3:.3f} us by {k['bound_by']}) on {card}")
    with torch.inference_mode():
        serve_ms = call_ms(lambda: [dlrm.forward(p, inp, cfg)
                                    for inp in inputs], reps=5) / n_b
        retrieval_ms = time_ms(lambda: dlrm.retrieval_score(p, rbatch, cfg),
                               [()], reps=5, launches=24)
    step_ms = call_ms(lambda: step_fn(state0, tb), reps=3)
    print(f"[bf16] on {card}, CUDA events: serve step (kernels), warm, per "
          f"batch of {b}: {serve_ms:.3f} ms (5 passes over the "
          f"{n_b} batches); retrieval {retrieval_ms:.3f} ms per 1 x "
          f"{N_CANDIDATES} call; training step (forward, backward, "
          f"optimizer) at batch {TRAIN['batch']}: {step_ms:.1f} ms")
    return dict(launches=launches, kernels=kernels, serve_ms=serve_ms,
                retrieval_ms=retrieval_ms, step_ms=step_ms,
                logit_err=max(errs), retrieval_err=r_err, grad_err=grad_err,
                peak_gib=peak)


def _din_batch(cfg, b: int, rng: np.random.Generator, labels: bool) -> dict:
    lens = rng.integers(1, cfg.seq_len + 1, b)
    batch = {"hist": rng.integers(0, cfg.n_items, (b, cfg.seq_len)),
             "hist_mask": np.arange(cfg.seq_len)[None, :] < lens[:, None],
             "target": rng.integers(0, cfg.n_items, b),
             "profile": rng.standard_normal((b, cfg.n_profile)
                                            ).astype(np.float32)}
    if labels:
        batch["labels"] = (rng.random(b) > 0.5).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _bert_batch(cfg, b: int, rng: np.random.Generator, n_mask: int = 0
                ) -> dict:
    """Item sequences padded at the front to random lengths; with
    ``n_mask``, that many distinct positions of each are masked (item 0)
    and their ids become the cloze targets."""
    t = cfg.seq_len
    items = rng.integers(1, cfg.n_items, (b, t))
    lens = rng.integers(max(n_mask, 2), t + 1, b)
    batch = {"pad_mask": np.arange(t)[None, :] >= (t - lens)[:, None]}
    if n_mask:
        pos = np.sort(np.stack([t - 1 - rng.choice(n, n_mask, replace=False)
                                for n in lens]), axis=1)
        batch["mask_pos"] = pos
        batch["targets"] = np.take_along_axis(items, pos, 1)
        batch["target_mask"] = np.ones((b, n_mask), bool)
        np.put_along_axis(items, pos, cfg.mask_token, 1)
    batch["items"] = items
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def phase_recsys(card: str) -> dict:
    """DIN, BERT4Rec and GraphSAGE at the registry's configs: each run on
    the card and held against the same port function on the CPU with the
    same params; timed with CUDA events. None launches a kernel of the
    port."""
    from repro_torch.data.sampler import CSRGraph, sample_blocks
    from repro_torch.models import bert4rec, din, graphsage
    cuda = torch.device("cuda")
    rng = np.random.default_rng(0)
    out: dict = {}
    reset_counts()

    def on_card(batch):
        return {k: (v.to(cuda) if torch.is_tensor(v) else _to(v, cuda))
                for k, v in batch.items()}

    def both(label, fn, params, batch, grads=False, biases=()):
        """``fn`` on the card and on the CPU, held together (with the
        gradients of ``biases`` joined to their layers' weights); the
        card's ms per call."""
        pc = _to(params, cuda)
        bc = on_card(batch)
        if grads:
            got, g_got = _grads(lambda q: fn(q, bc), pc)
            want, g_want = _grads(lambda q: fn(q, batch), params)
            compare(f"{label} loss, card vs CPU", got, want.to(cuda),
                    RECSYS_TOL)
            err = check_tensors(
                f"{label} gradients, card vs CPU",
                _join_softmax_biases(params, g_got, biases),
                _join_softmax_biases(params, [g.to(cuda) for g in g_want],
                                     biases), RECSYS_GRAD_REL_L2)
            ms = call_ms(lambda: _grads(lambda q: fn(q, bc), pc), reps=3)
        else:
            with torch.inference_mode():
                got = fn(pc, bc)
                err = compare(f"{label}, card vs CPU", got,
                              fn(params, batch).to(cuda), RECSYS_TOL)
                ms = call_ms(lambda: fn(pc, bc))
        print(f"[recsys] {label}: {ms:.3f} ms per call on {card}")
        out[label] = dict(ms=ms, err=err)

    # DIN at din_arch.CONFIG
    cfg = configs.DIN
    params = din.init(0, cfg, device="cpu")
    shapes = configs.RECSYS_SHAPES
    both(f"din forward, serve_p99 (batch {shapes['serve_p99']['batch']})",
         lambda q, b: din.forward(q, b, cfg), params,
         _din_batch(cfg, shapes["serve_p99"]["batch"], rng, False))
    both(f"din loss and gradients, batch {TRAIN['batch']}",
         lambda q, b: din.loss(q, b, cfg), params,
         _din_batch(cfg, TRAIN["batch"], rng, True), grads=True,
         biases=(f"['attn'][{len(cfg.attn_mlp)}]['b']",))
    user = _din_batch(cfg, 1, rng, False)
    cands = torch.from_numpy(rng.integers(0, cfg.n_items, N_CANDIDATES))
    rb = {"hist": user["hist"], "hist_mask": user["hist_mask"],
          "profile": user["profile"], "candidates": cands}
    pc, rbc = _to(params, cuda), on_card(rb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        scores = din.retrieval_score(pc, rbc, cfg)
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        # each candidate's score depends on its own row alone, so the CPU
        # scores a sample of them
        n_sel = min(8192, N_CANDIDATES)
        sel = torch.from_numpy(rng.choice(N_CANDIDATES, n_sel,
                                          replace=False))
        err = compare(f"din retrieval (1 x {N_CANDIDATES}, chunks of "
                      f"{din.RETRIEVAL_CHUNK}) at {n_sel} sampled "
                      f"candidates, "
                      f"card vs CPU", scores[sel.to(cuda)],
                      din.retrieval_score(params, {**rb, "candidates":
                                                   cands[sel]}, cfg).to(cuda),
                      RECSYS_TOL)
        ms = call_ms(lambda: din.retrieval_score(pc, rbc, cfg), reps=2)
    print(f"[recsys] din retrieval, 1 x {N_CANDIDATES} in chunks of "
          f"{din.RETRIEVAL_CHUNK}: {ms:.3f} ms per call on {card}; peak "
          f"device memory above the model {peak_gb:.2f} GB")
    out["din retrieval"] = dict(ms=ms, err=err, peak_gb=peak_gb)
    del pc, rbc, scores

    # BERT4Rec at the registry's config (26,752 items, d 64, seq 200)
    cfg = configs.BERT4REC
    params = bert4rec.init(0, cfg, device="cpu")
    both(f"bert4rec score, serve_p99 (batch {shapes['serve_p99']['batch']})",
         lambda q, b: bert4rec.score(q, b, cfg), params,
         _bert_batch(cfg, shapes["serve_p99"]["batch"], rng))
    both(f"bert4rec cloze loss and gradients, batch 1024, "
         f"{configs.BERT4REC_N_MASK} masked positions",
         lambda q, b: bert4rec.loss(q, b, cfg), params,
         _bert_batch(cfg, 1024, rng, configs.BERT4REC_N_MASK), grads=True,
         biases=tuple(f"['blocks'][{i}]['wk']['b']"
                      for i in range(cfg.n_blocks)))
    rb = {**_bert_batch(cfg, 1, rng),
          "candidates": torch.from_numpy(rng.integers(0, cfg.n_items,
                                                      N_CANDIDATES))}
    both(f"bert4rec retrieval, 1 x {N_CANDIDATES} candidate ids",
         lambda q, b: bert4rec.retrieval_score(q, b, cfg), params, rb)

    # GraphSAGE: Reddit-scale sampled training on a synthetic graph
    cfg = configs.CFG_REDDIT
    shp = configs.SAGE_SHAPES["minibatch_lg"]
    n, deg = shp["n_nodes"], SAGE_AVG_DEGREE
    t0 = time.perf_counter()
    graph = CSRGraph.random(n, deg, cfg.d_in, cfg.n_classes, seed=0)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks = sample_blocks(graph, rng.choice(n, shp["batch_nodes"],
                                             replace=False),
                           cfg.fanouts, rng)
    t_sample = time.perf_counter() - t0
    del graph
    blocks = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                  else [torch.from_numpy(x) for x in v])
              for k, v in blocks.items()}
    print(f"[recsys] graphsage reddit graph: {n} nodes x {deg} in-edges "
          f"each on average ({n * deg} edges), {cfg.d_in} features, built "
          f"on the host in {t_graph:.1f} s; {shp['batch_nodes']} seeds "
          f"sampled with fanouts {cfg.fanouts} in {t_sample:.2f} s: "
          f"{blocks['feats'].shape[0]} input nodes, blocks "
          f"{[tuple(x.shape) for x in blocks['nbrs']]}")
    params = graphsage.init(0, cfg, device="cpu")
    both(f"graphsage reddit sampled loss and gradients, "
         f"{shp['batch_nodes']} seeds, fanouts {cfg.fanouts}",
         lambda q, b: graphsage.loss_node(q, b, cfg, "sampled"), params,
         blocks, grads=True)
    out["graphsage reddit set-up s"] = dict(graph=t_graph, sample=t_sample)

    # Cora-sized full graph
    cfg = configs.CFG_CORA
    shp = configs.SAGE_SHAPES["full_graph_sm"]
    n, e = shp["n_nodes"], shp["n_edges"]
    train = np.zeros(n, np.float32)
    train[rng.choice(n, 140, replace=False)] = 1.0
    batch = {"feats": torch.from_numpy(rng.standard_normal(
                 (n, shp["d_feat"])).astype(np.float32)),
             "edge_src": torch.from_numpy(rng.integers(0, n, e)),
             "edge_dst": torch.from_numpy(rng.integers(0, n, e)),
             "labels": torch.from_numpy(rng.integers(0, cfg.n_classes, n)),
             "train_mask": torch.from_numpy(train)}
    params = graphsage.init(1, cfg, device="cpu")
    both(f"graphsage cora full-graph loss and gradients ({n} nodes, {e} "
         f"edges)", lambda q, b: graphsage.loss_node(q, b, cfg, "full"),
         params, batch, grads=True)

    # batched molecule graphs
    cfg = configs.CFG_MOLECULE
    shp = configs.SAGE_SHAPES["molecule"]
    b, n, e = shp["batch"], shp["n_nodes"], shp["n_edges"]
    sizes = rng.integers(n // 2, n + 1, b)
    batch = {"x": torch.from_numpy(rng.standard_normal(
                 (b, n, cfg.d_in)).astype(np.float32)),
             "edges": torch.from_numpy(np.stack([rng.integers(0, s, (e, 2))
                                                 for s in sizes])),
             "edge_mask": torch.from_numpy(rng.random((b, e)) < 0.9),
             "node_mask": torch.from_numpy(np.arange(n)[None, :]
                                           < sizes[:, None]),
             "labels": torch.from_numpy(rng.integers(0, cfg.n_classes, b))}

    def molecule_loss(q, bt):
        logits = graphsage.forward_batched_graphs(
            q, bt["x"], bt["edges"], bt["edge_mask"], bt["node_mask"], cfg)
        logp = torch.log_softmax(logits.float(), -1)
        return -logp.gather(1, bt["labels"][:, None]).mean()

    params = graphsage.init(2, cfg, device="cpu")
    both(f"graphsage molecule loss and gradients ({b} graphs x {n} nodes x "
         f"{e} edges)", molecule_loss, params, batch, grads=True)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"[recsys] launches of the port's kernels over the phase: "
          f"{launches}")
    if any(launches.values()):
        raise AssertionError("the recsys models launched a DLRM kernel")
    return dict(launches=launches, results=out)


# ------------------------------------------------------------- registry --
# the registry phase: the registry's plans (configs.get_arch(name).steps
# [cell].make_fn(bundle, None, False)) on real tensors on the card at the
# plans' full shapes; the DLRM archs' cells through the kernels, each held
# against the same plan built with plain=True
REGISTRY_DLRM = (("dlrm-mlperf", ("serve_p99", "serve_bulk",
                                  "retrieval_cand")),
                 ("dlrm-rm2", ("serve_p99", "retrieval_cand")),
                 ("rmc1", ("serve_p99", "retrieval_cand")),
                 ("rmc2", ("serve_p99", "retrieval_cand")),
                 ("rmc3", ("serve_p99", "retrieval_cand")))
# dlrm-rm2's train_batch step (65,536 samples): the plain route's loss of
# the same batch, taken in chunks (its gathered rows are 35 GB at once)
REGISTRY_TRAIN = "dlrm-rm2"
REGISTRY_PLAIN_CHUNK = 4096
# the plain=True retrieval plan over the candidates in this many chunks
# (each score depends on its own candidate alone): its interaction
# materialises z = [bottom; bags], 13.8 GB in f32 for 1M dlrm-mlperf rows
REGISTRY_RETRIEVAL_CHUNKS = 4
# launches of one kernel-route call of a serve / retrieval plan
SERVE_LAUNCHES = {"recflash_sls_grouped": 1, "dot_interaction_fused": 1,
                  "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                  "recflash_sls": 0, "dot_interaction": 0}
RETRIEVAL_LAUNCHES = {**SERVE_LAUNCHES, "recflash_sls": 1}


def _registry_dlrm_batch(cfg, cell: str, rank_of: list,
                         gen: torch.Generator) -> dict:
    """A DLRM cell's batch on the card at its full shape (the registry's
    make_batch): random ids, with each table's last id and the id of its
    last stored row (the rank_of preimage of V-1, the row at the largest
    offset) among them; for retrieval these two ids of the last table lead
    the candidates."""
    shp = configs.RECSYS_SHAPES[cell]
    b, dev = shp["batch"], "cuda"
    idx = torch.stack([torch.randint(0, v, (b, cfg.lookups), generator=gen,
                                     device=dev, dtype=torch.int32)
                       for v in cfg.n_rows], dim=1)
    last_row = [int((r == r.numel() - 1).nonzero()[0, 0]) for r in rank_of]
    for t, v in enumerate(cfg.n_rows):
        idx[0, t, 0] = v - 1
        idx[min(1, b - 1), t, min(1, cfg.lookups - 1)] = last_row[t]
    batch = {"dense": torch.randn(b, cfg.n_dense, generator=gen, device=dev),
             "indices": idx, "rank_of": rank_of}
    if cell == "train_batch":
        batch["labels"] = (torch.rand(b, generator=gen, device=dev)
                           < 0.3).float()
    if cell == "retrieval_cand":
        cand = torch.randint(0, cfg.n_rows[-1], (shp["n_candidates"],),
                             generator=gen, device=dev, dtype=torch.int32)
        cand[0], cand[1] = cfg.n_rows[-1] - 1, last_row[-1]
        batch["candidates"] = cand
    return batch


def registry_kernel_times(name: str, params: dict, batch: dict) -> dict:
    """Both kernels at an arch's serve_p99 inputs: time per launch, the
    plain version's, the bound, and the error against the plain version."""
    p = dlrm.add_remap(params, batch["rank_of"])
    idx = batch["indices"]
    b, n_t, lk = idx.shape
    dim = p["tables"][0].shape[1]
    g_call = (p["tables"], p["hot_sizes"], idx, p["rank_of"], p["sls_desc"])
    g_bytes, _ = sls_bytes(p, [batch])
    esize = p["tables"][0].element_size()
    with torch.inference_mode():
        x = mlp(p["bot"], batch["dense"])
        bags = dlrm.bags(p, idx)
        dt = torch.promote_types(x.dtype, bags.dtype)
        f_call = (x.to(dt), bags.to(dt))
        t = n_t + 1
        n_tri = t * (t - 1) // 2
        isize = torch.empty((), dtype=dt).element_size()
        flops_type = F32_FLOPS if dt == torch.float32 else BF16_FLOPS
        sls_type = F32_FLOPS if esize == 4 else BF16_FLOPS
        out = {}
        for entry, fn, plain, call, n_bytes, n_flops, ftype, tol, ln in (
                ("recflash_sls_grouped", recflash_sls_grouped,
                 ops.sls_grouped_ref, g_call, g_bytes, b * n_t * lk * dim,
                 sls_type, out_tol(p["tables"][0].dtype), 4 * n_t + lk + 2),
                ("dot_interaction_fused", dot_interaction_fused, ops.fused_ref,
                 f_call, b * t * dim * isize + b * (dim + n_tri) * isize,
                 2 * b * n_tri * dim, flops_type, out_tol(dt), 10)):
            args = call if entry == "dot_interaction_fused" else call[:4]
            err = compare(f"registry {name}: {entry} vs its plain version at "
                          f"serve_p99", fn(*call), plain(*args), tol)
            bound, by = bound_ms(n_bytes, n_flops, ftype)
            out[entry] = dict(
                shape=(f"B {b}, T {n_t}, L {lk}, D {dim} "
                       f"{str(p['tables'][0].dtype)[6:]}"
                       if entry == "recflash_sls_grouped" else
                       f"B {b}, T {t}, D {dim} {str(dt)[6:]}"),
                ms=time_ms(fn, [call], reps=50),
                plain_ms=time_ms(plain, [args], reps=5, launches=ln),
                bound_ms=bound, bound_by=by, max_abs_err=err)
            print(f"[registry] {name} {entry} ({out[entry]['shape']}): "
                  f"{out[entry]['ms'] * 1e3:.2f} us/launch, plain "
                  f"{out[entry]['plain_ms'] * 1e3:.2f} us, bound "
                  f"{bound * 1e3:.3f} us by {by}")
    return out


def registry_dlrm(name: str, cells: tuple, card: str,
                  launches: dict) -> dict:
    """``name``'s registry bundle on the card (its own dtype rule), a
    permutation per table as rank_of, and each of ``cells`` through its
    plan: one kernel-route call counted into ``launches``, held against the
    plain=True plan on the same inputs, then timed."""
    bundle = configs.get_arch(name)
    cfg = bundle.cfg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init(0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    rank_of = [torch.randperm(v, generator=gen, device="cuda",
                              dtype=torch.int32) for v in cfg.n_rows]
    torch.cuda.synchronize()
    table_gb = sum(t.numel() * t.element_size() for t in params["tables"])
    print(f"[registry] {name}: {cfg.n_tables} tables, {sum(cfg.n_rows)} "
          f"rows x {cfg.embed_dim} {str(params['tables'][0].dtype)[6:]} "
          f"({table_gb / 1e9:.2f} GB) and rank_of "
          f"({sum(r.numel() for r in rank_of) * 4 / 1e9:.2f} GB) made on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    out: dict = {"cells": {}}
    for cell in cells:
        step = bundle.steps[cell]
        fn = step.make_fn(bundle, None, False).fn
        plain = step.make_fn(bundle, None, False, plain=True).fn
        batch = _registry_dlrm_batch(cfg, cell, rank_of, gen)

        def plain_call(plain=plain, batch=batch):
            if "candidates" not in batch:
                return plain(params, batch)
            return torch.cat([plain(params, {**batch, "candidates": c})
                              for c in batch["candidates"].chunk(
                                  REGISTRY_RETRIEVAL_CHUNKS)])

        with torch.inference_mode():
            reset_counts()
            got = fn(params, batch)
            torch.cuda.synchronize()
            counted = read_counts()
            for k, v in counted.items():
                launches[k] += v
            want_launches = (RETRIEVAL_LAUNCHES if cell == "retrieval_cand"
                             else SERVE_LAUNCHES)
            if counted != want_launches:
                raise AssertionError(f"{name} {cell}: launches {counted} != "
                                     f"{want_launches}")
            n = configs.RECSYS_SHAPES[cell].get(
                "n_candidates", configs.RECSYS_SHAPES[cell]["batch"])
            if got.shape != (n,) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {cell}: logits not finite or "
                                     f"not ({n},)")
            err = compare(f"registry {name} {cell}: logits, kernels vs "
                          f"plain=True plan", got, plain_call(), LOGIT_TOL)
            del got
            ms = call_ms(lambda fn=fn, batch=batch: fn(params, batch))
            plain_ms = call_ms(plain_call, reps=2)
        out["cells"][cell] = dict(ms=ms, plain_ms=plain_ms, err=err,
                                  launches=counted)
        print(f"[registry] {name} {cell} ({n} rows): {ms:.3f} ms per call "
              f"on {card} (plain=True {plain_ms:.3f} ms); launches per call "
              f"{counted}; max abs err {err:.3e}")
        if cell == "serve_p99":
            out["kernels"] = registry_kernel_times(name, params, batch)
        del batch
    if name == REGISTRY_TRAIN:
        out["train"] = registry_train(bundle, params, rank_of, gen, card,
                                      launches)
    torch.cuda.synchronize()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[registry] {name}: peak device memory {out['peak_gb']:.2f} GB")
    del params, rank_of
    gc.collect()
    torch.cuda.empty_cache()
    return out


def registry_train(bundle, params, rank_of, gen, card: str,
                   launches: dict) -> dict:
    """One step of the bundle's train_batch plan at its 65,536 samples
    (row-wise adagrad on the tables, AdamW on the MLPs): the loss against
    the plain route's on the same batch, the step's time and peak memory."""
    cfg = bundle.cfg
    step = bundle.steps["train_batch"]
    plan = step.make_fn(bundle, None, False)
    loss_fn = step.make_fn.keywords["loss_fn"]
    batch = _registry_dlrm_batch(cfg, "train_batch", rank_of, gen)
    opt_state = bundle.optimizer.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    new_params, _, loss = plan.fn(params, opt_state, batch)
    torch.cuda.synchronize()
    counted = read_counts()
    for k, v in counted.items():
        launches[k] += v
    if counted != SERVE_LAUNCHES:
        raise AssertionError(f"train step launches {counted} != "
                             f"{SERVE_LAUNCHES}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(torch.isfinite(x).all() for x in tree.leaves(new_params)):
        raise AssertionError("the train step's params are not finite")
    del new_params
    b = batch["labels"].shape[0]
    with torch.no_grad():
        parts = []
        for lo in range(0, b, REGISTRY_PLAIN_CHUNK):
            chunk = {k: (v[lo:lo + REGISTRY_PLAIN_CHUNK]
                         if k != "rank_of" else v) for k, v in batch.items()}
            part = loss_fn(params, chunk, None, ("data",), plain=True)
            parts.append(part * chunk["labels"].shape[0])
        plain_loss = torch.stack(parts).sum() / b
    err = compare(f"registry {bundle.name} train_batch: loss, kernels vs "
                  f"the plain route (in chunks of {REGISTRY_PLAIN_CHUNK})",
                  loss, plain_loss, LOSS_TOL)
    ms = call_ms(lambda: plan.fn(params, opt_state, batch), reps=2)
    print(f"[registry] {bundle.name} train_batch ({b} samples, row-wise "
          f"adagrad + AdamW): {ms:.1f} ms per step on {card}, loss "
          f"{float(loss):.6f}, launches {counted}, peak device memory "
          f"{peak:.2f} GB")
    return dict(ms=ms, err=err, peak_gb=peak, loss=float(loss))


def registry_other(card: str) -> dict:
    """DIN's and BERT4Rec's serve_p99 plans and GraphSAGE's molecule and
    full_graph_sm train plans at full size, on the card against the same
    plan on the CPU with the same params and inputs."""
    from repro_torch.models import graphsage
    cuda = torch.device("cuda")
    rng = np.random.default_rng(3)
    out = {}
    for name, batch_fn in (
            ("din", lambda cfg, b: _din_batch(cfg, b, rng, False)),
            ("bert4rec", lambda cfg, b: _bert_batch(cfg, b, rng))):
        bundle = configs.get_arch(name)
        plan = bundle.steps["serve_p99"].make_fn(bundle, None, False)
        params = bundle.init(0, device="cpu")
        batch = batch_fn(bundle.cfg, configs.RECSYS_SHAPES["serve_p99"]
                         ["batch"])
        pc, bc = _to(params, cuda), _to(batch, cuda)
        with torch.inference_mode():
            err = compare(f"registry {name} serve_p99, card vs CPU",
                          plan.fn(pc, bc), plan.fn(params, batch).to(cuda),
                          RECSYS_TOL)
            ms = call_ms(lambda plan=plan, pc=pc, bc=bc: plan.fn(pc, bc))
        out[f"{name} serve_p99"] = dict(ms=ms, err=err)
        print(f"[registry] {name} serve_p99: {ms:.3f} ms per call on {card}")
    bundle = configs.get_arch("graphsage-reddit")
    for cell in ("molecule", "full_graph_sm"):
        plan = bundle.steps[cell].make_fn(bundle, None, False)
        shapes = {k: tuple(x.shape) for k, x in plan.args[2].items()}
        batch = _sage_registry_batch(shapes, rng)
        params = graphsage.init(0, bundle.steps[cell].make_fn.keywords["cfg"],
                                device="cpu")
        opt_state = bundle.optimizer.init(params)
        pc, oc, bc = _to(params, cuda), _to(opt_state, cuda), _to(batch, cuda)
        g_loss, g_grads = plan.grads(pc, bc)
        w_loss, w_grads = plan.grads(params, batch)
        err = compare(f"registry graphsage {cell}: loss, card vs CPU",
                      g_loss, w_loss.to(cuda), RECSYS_TOL)
        check_tensors(f"registry graphsage {cell}: gradients, card vs CPU",
                      tree.leaves(g_grads),
                      [g.to(cuda) for g in tree.leaves(w_grads)],
                      RECSYS_GRAD_REL_L2)
        check_tensors(f"registry graphsage {cell}: params after the AdamW "
                      f"step, card vs CPU",
                      tree.leaves(plan.fn(pc, oc, bc)[0]),
                      [x.to(cuda) for x in tree.leaves(
                          plan.fn(params, opt_state, batch)[0])],
                      RECSYS_GRAD_REL_L2)
        ms = call_ms(lambda plan=plan, pc=pc, oc=oc, bc=bc: plan.fn(
            pc, oc, bc), reps=3)
        out[f"graphsage {cell}"] = dict(ms=ms, err=err)
        print(f"[registry] graphsage {cell} train step: {ms:.3f} ms per "
              f"step on {card}")
    return out


def _sage_registry_batch(shapes: dict, rng: np.random.Generator) -> dict:
    """Inputs of a GraphSAGE train plan's batch shapes: a random Cora-sized
    graph (140 training nodes) or random molecule graphs."""
    if "edges" in shapes:
        b, n, d = shapes["x"]
        e = shapes["edges"][1]
        sizes = rng.integers(n // 2, n + 1, b)
        batch = {"x": rng.standard_normal((b, n, d)).astype(np.float32),
                 "edges": np.stack([rng.integers(0, s, (e, 2))
                                    for s in sizes]).astype(np.int32),
                 "edge_mask": rng.random((b, e)) < 0.9,
                 "node_mask": np.arange(n)[None, :] < sizes[:, None],
                 "labels": rng.integers(0, 2, b).astype(np.int32)}
    else:
        n, d = shapes["feats"]
        e = shapes["edge_src"][0]
        train = np.zeros(n, np.float32)
        train[rng.choice(n, 140, replace=False)] = 1.0
        batch = {"feats": rng.standard_normal((n, d)).astype(np.float32),
                 "edge_src": rng.integers(0, n, e).astype(np.int32),
                 "edge_dst": rng.integers(0, n, e).astype(np.int32),
                 "labels": rng.integers(0, 7, n).astype(np.int32),
                 "train_mask": train}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def phase_registry(card: str) -> dict:
    """The registry's recsys and GNN plans with mesh None at their full
    shapes on the card: dlrm-mlperf in bf16 (48.07 GB of tables) through
    serve_p99, serve_bulk and retrieval_cand, dlrm-rm2 and rmc1-3 through
    serve_p99 and retrieval_cand, each held against its plain=True plan,
    with both kernels timed at each arch's serve inputs; one train_batch
    step of dlrm-rm2 at 65,536 samples; DIN and BERT4Rec serve_p99 and
    GraphSAGE's molecule and full_graph_sm steps, card against CPU."""
    t0 = time.perf_counter()
    launches = {k: 0 for k in COUNTERS}
    out: dict = {"archs": {}}
    for name, cells in REGISTRY_DLRM:
        out["archs"][name] = registry_dlrm(name, cells, card, launches)
    out["other"] = registry_other(card)
    out["launches"] = launches
    print(f"[registry] launches of the port's kernels over the phase's "
          f"counted calls: {launches}; the phase took "
          f"{time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------------ dcn --
# DLRM-DCNv2's tables cut to at most this many rows (its widths, bag
# lengths and bf16 tables kept), and the batch its forward is checked at
DCN_ROWS = 100_000
DCN_BATCH = 4096


def _dcn_model(gen: torch.Generator):
    """DLRM-DCNv2 with tables of at most ``DCN_ROWS`` rows in bf16, stored
    in the order of a random permutation, the remap attached; nonzero
    biases. Returns (cfg, params)."""
    from repro_torch.configs import dlrm_dcnv2
    cfg = dataclasses.replace(dlrm_dcnv2.CONFIG, n_rows=tuple(
        min(v, DCN_ROWS) for v in dlrm_dcnv2.CONFIG.n_rows))
    p = dlrm.init(0, cfg, device="cuda")
    for layer in p["bot"] + p["cross"] + p["top"]:
        layer["b"].normal_(0.0, 0.1, generator=gen)
    rank_of = [torch.randperm(v, generator=gen, device="cuda")
               for v in cfg.n_rows]
    tables = [t.to(torch.bfloat16)[r.argsort()]
              for t, r in zip(p["tables"], rank_of, strict=True)]
    hot = [max(1, v // 500) for v in cfg.n_rows]
    return cfg, dlrm.add_remap({**p, "tables": tables}, rank_of, hot)


def _dcn_batch(cfg, b: int, gen: torch.Generator) -> dict:
    ids = [torch.randint(0, v, (b, n), generator=gen, device="cuda")
           for v, n in zip(cfg.n_rows, cfg.lookups, strict=True)]
    return {"dense": torch.randn(b, cfg.n_dense, generator=gen,
                                 device="cuda"),
            "indices": torch.cat(ids, dim=1).to(torch.int32)}


def phase_dcn(card: str, gen: torch.Generator) -> dict:
    """MLPerf's DLRM-DCNv2 through the port on the card (module docstring,
    phase 14). Returns the launches of the phase's counted calls and the
    times."""
    t0 = time.perf_counter()
    cfg, p = _dcn_model(gen)
    tables, hot, rank_of = p["tables"], p["hot_sizes"], p["rank_of"]
    reset_counts()
    out: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        tabs = [t.to(dtype) for t in tables]
        desc = describe(tabs, hot, rank_of)
        for b in (1, 1024):
            idx = _dcn_batch(cfg, b, gen)["indices"]
            got = recflash_sls_grouped(tabs, hot, idx, rank_of, desc,
                                       cfg.lookups)
            want = ops.sls_grouped_ref(tabs, hot, idx, rank_of, cfg.lookups)
            compare(f"recflash_sls_grouped ragged {str(dtype)[6:]} (26 "
                    f"tables, bags of 1 to 100, D=128, B={b})", got, want,
                    dict(rtol=0.0, atol=0.0))
        # bags of one length: a uniform launch and a ragged one
        flat = torch.stack([torch.randint(0, v, (b, 8), generator=gen,
                                          device="cuda")
                            for v in cfg.n_rows], dim=1).to(torch.int32)
        uni = recflash_sls_grouped(tabs, hot, flat, rank_of, desc)
        compare(f"recflash_sls_grouped uniform vs ragged {str(dtype)[6:]} "
                f"(L=8)", uni, recflash_sls_grouped(
                    tabs, hot, flat.flatten(1), rank_of, desc, (8,) * 26),
                dict(rtol=0.0, atol=0.0))
        del tabs, desc
    big = _dcn_batch(cfg, DCN_BATCH, gen)
    idx = big["indices"]
    n_bytes = idx.numel() * 4 + DCN_BATCH * 26 * 128 * 2
    for t, ids in enumerate(idx.split(cfg.lookups, dim=1)):
        n_bytes += int(torch.unique(ids).numel()) * (128 * 2 + 4)
    out["sls_ms"] = time_ms(
        lambda: recflash_sls_grouped(tables, hot, idx, rank_of,
                                     p["sls_desc"], cfg.lookups), [()] * 8)
    out["sls_bound_ms"], _ = bound_ms(n_bytes, idx.numel() * 128)
    with torch.inference_mode():
        small = _dcn_batch(cfg, 64, gen)
        eager = {**p, dlrm.GRAPHS: None}
        replays = dlrm.forward.graph_replays
        for _ in range(3):               # capture, then two replays
            got = dlrm.forward(p, small, cfg)
            want = dlrm.forward(eager, small, cfg)
            compare("dlrm-dcnv2 forward, graph replay vs eager (64 rows)",
                    got, want, dict(rtol=0.0, atol=0.0))
        if dlrm.forward.graph_replays - replays != 2:
            raise AssertionError("the DCN forward at 64 rows never "
                                 "replayed its graph")
        got = dlrm.forward(p, big, cfg)
        compare(f"dlrm-dcnv2 forward vs plain=True ({DCN_BATCH} rows)", got,
                dlrm.forward(p, big, cfg, plain=True), LOGIT_TOL)
        out["forward_ms"] = time_ms(
            lambda: dlrm.forward(p, big, cfg), [()] * 4, launches=40)
    out["launches"] = read_counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[dcn] on {card}: ragged SLS {out['sls_ms']:.3f} ms at "
          f"{DCN_BATCH} (bound {out['sls_bound_ms']:.3f} ms), forward "
          f"{out['forward_ms']:.3f} ms at {DCN_BATCH}; launches "
          f"{out['launches']}; the phase took {time.perf_counter() - t0:.1f}"
          f" s")
    del p, tables, rank_of
    return out


# ------------------------------------------------------------ sls_probe --
def phase_sls_probe(card: str) -> dict:
    """The grouped SLS at rmc2's shape on ids that place every lookup in
    one level of the cache (module docstring, phase 15). Returns the
    probe's record a case."""
    sys.path.insert(0, str(ROOT))
    from tools import sls_probe
    t0 = time.perf_counter()
    recs = [r for r in sls_probe.probe([ROOT], rounds=1,
                                       cases=sls_probe.CASES)
            if "case" in r]
    for r in recs:
        print(f"[sls_probe] {r['case']} on {card}: {r['ms'] * 1e3:.2f} us a "
              f"launch (bound {r['bound_ms'] * 1e3:.2f} us by "
              f"{r['bound_by']}, {r['roofline_pct']:.2f}%), rows read at "
              f"{r['row_copies_tb_s']:.2f} TB/s")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[sls_probe] the phase took {time.perf_counter() - t0:.1f} s")
    return {r["case"]: r for r in recs}


# --------------------------------------------------------------- dryrun --
DRYRUN_TIMEOUT_S = 900
# the dry-run's cells the card phases read, on the 16 x 16 mesh: lm_blocks'
# qwen3-1.7b cells and deepseek-v3's decode_32k, recsys_mesh's DIN and
# BERT4Rec cells; two processes at once (every cell of every arch on both
# meshes is ``python -m repro_torch.launch.dryrun --arch all --mesh both``
# on any CPU, the card idle)
DRYRUN_RUNS = ((["--arch", "qwen3-1.7b,din,bert4rec"], 6),
               (["--arch", "deepseek-v3-671b", "--shape", "decode_32k"], 1))


def phase_dryrun() -> dict:
    """``python -m repro_torch.launch.dryrun --mesh single`` over the cells
    of DRYRUN_RUNS, in subprocesses (this process held NCCL in the mesh
    phases) started together, into temporary files: each cell's plan on
    rank 0's blocks of a fake 256-rank group, counted on meta tensors.
    Fails on any failed cell."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        procs = []
        for i, (sel, jobs) in enumerate(DRYRUN_RUNS):
            path = os.path.join(d, f"dryrun_{i}.json")
            procs.append((path, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *sel,
                 "--mesh", "single", "--jobs", str(jobs), "--out", path],
                cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        recs, failed = [], []
        for path, proc in procs:
            try:
                stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            finally:
                proc.kill()
            if proc.returncode != 0:
                failed.append(f"{stdout[-3000:]}\n{stderr[-3000:]}")
            if os.path.exists(path):
                recs.extend(json.load(open(path)))
    counts = {s: sum(x["status"] == s for x in recs)
              for s in ("ok", "skip", "error")}
    for x in sorted(recs, key=lambda x: (x["mesh"], x["arch"], x["shape"])):
        if x["status"] == "ok":
            roof = x["roofline"]
            print(f"[dryrun] {x['arch']} x {x['shape']} @ {x['mesh']}: "
                  f"flops/rank {roof['flops_per_device']:.3e}, bytes/rank "
                  f"{roof['bytes_per_device']:.3e}, wire/rank "
                  f"{roof['wire_bytes_per_device']:.3e}, bound "
                  f"{roof['t_bound'] * 1e3:.3f} ms by {roof['bottleneck']}, "
                  f"peak {roof['memory']['peak_bytes'] / 1e9:.2f} GB, "
                  f"fits_hbm {roof['memory']['fits_hbm']}")
        elif x["status"] == "error":
            print(f"[dryrun] {x['arch']} x {x['shape']} @ {x['mesh']}: "
                  f"FAILED {x['error']}")
    print(f"[dryrun] {counts['ok']} ok / {counts['skip']} skip / "
          f"{counts['error']} fail in {time.perf_counter() - t0:.1f} s")
    if failed or counts["error"] or not counts["ok"]:
        raise AssertionError("the dry-run failed:\n" + "\n".join(failed))
    return dict(counts=counts, records=recs)


# ------------------------------------------------------------------- LM --
# the LM phase runs in bf16, as the reference's serve cells do
# (src/repro/configs/lm_common.py): prefill at train_4k's length, then
# LM_DECODE_STEPS teacher-forced decode steps into a cache of LM_SEQ +
# LM_DECODE_STEPS slots, held against one full forward over LM_FULL_SEQ
# tokens (chunkable by 512 and 1024, so it runs the flash path too)
LM_SEQ = 4096
LM_DECODE_STEPS = 32
LM_FULL_SEQ = 5120
# (arch, the config's cut of depth, batch of the timed bf16 prefill and
# decode, the float32 decode-vs-full check as (batch, prefill length,
# forward length)): qwen3-1.7b at full width and depth, the others at full
# width and the depth one card holds
LM_RUNS = (
    ("qwen3-1.7b", {}, 8, (2, LM_SEQ, LM_FULL_SEQ)),
    ("qwen2-0.5b", dict(n_layers=2), 8, (2, LM_SEQ, LM_FULL_SEQ)),
    ("nemotron-4-15b", dict(n_layers=2), 8, (2, LM_SEQ, LM_FULL_SEQ)),
    ("qwen3-moe-30b-a3b", dict(n_layers=2), 8, (1, LM_SEQ, LM_FULL_SEQ)),
    ("deepseek-v3-671b", dict(n_layers=2, n_dense_layers=1), 2,
     (1, 480, 512)),
)
# the decode-vs-full property (tests/test_models.py) runs in float32, at
# the reference's own tolerance: each logit within 2e-3. In bf16 the two
# paths round differently at every op (1-2% relative L2 over 2-28 layers
# on an H100), and a MoE token whose top-k scores nearly tie can pick
# another expert on either path, so the bf16 drift is measured, not held
LM_CHECK_TOL = dict(rtol=0, atol=2e-3)
# flash_attention against SDPA in bf16 (one layer's attention, forward and
# gradients): ||got - want|| / ||want||
LM_ATTN_REL_L2 = 2e-2
# deepseek's train_loss (MTP head on), forward and backward, at full width
LM_TRAIN_SHAPE = (1, 512)
# the narrow variants held card against CPU (f32, TF32 off): the
# reference's reduced archs of tests/test_models.py, wider and longer so
# that attention runs several chunks
LM_NARROW = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                 vocab=512, rope_theta=10_000.0, remat=False, q_chunk=64,
                 kv_chunk=64)
LM_NARROW_SEQ = 128
# the lm-100m training of launch/train.py --model lm: at the CLI's default
# batch (seq 256 is its default too) its peak is 81.76 GB of an H100's
# 85.02 where it fits, and in most runs the allocator's fragmentation
# (15.6 GiB reserved but free) raises OOM; so the phase measures the
# defaults in process and trains, and runs the CLI, at LM_TRAIN_BATCH
LM_CLI_BATCH = 256
LM_TRAIN_BATCH = 64
# flash attention's shapes on the card (causal, as every LM path calls it):
# qwen3-1.7b's prefill, GQA 16/8, d 128; deepseek-v3's MLA at its lm batch,
# 128 heads with n_rep 1, qk 192 (nope 128 + rope 64) and v 128 a split
# view of the up-projected kv (row stride 256); and lm_mesh's
# context-parallel call of qwen2-0.5b (14/2 heads, d 64) as rank 2 of a
# 4-way model axis would make it: a quarter of the queries at q_start 2048
# against every key
ATTN_SHAPE = dict(b=8, t=LM_SEQ, h=16, kv=8, d=128)
MLA_SHAPE = dict(b=2, t=LM_SEQ, h=128, kv=128, d=192, dv=128, split_v=True)
CP_SHAPE = dict(b=8, t=LM_SEQ // 4, s=LM_SEQ, h=14, kv=2, d=64,
                q_start=LM_SEQ // 2)
# the attention of lm-100m's float32 training (launch/train.py --model lm at
# LM_TRAIN_BATCH, seq 256): 8 query heads over 4 kv heads, d 64
LM100M_ATTN_SHAPE = dict(b=LM_TRAIN_BATCH, t=256, h=8, kv=4, d=64)
# the kernel against its plain version in float32: the reference's own
# tolerances (tests/test_torch_attention.py), rtol 0
ATTN_F32_OUT_TOL = dict(rtol=0, atol=2e-5)
ATTN_F32_GRAD_TOL = dict(rtol=0, atol=5e-4)


def lm_narrow_configs() -> dict:
    """The five archs' reduced variants (tests/test_models.py's
    LM_VARIANTS) at LM_NARROW's width."""
    from repro_torch.models.lm import LMConfig
    from repro_torch.models.mla import MLAConfig
    from repro_torch.models.moe import MoEConfig

    def v(**kw):
        return LMConfig(name="narrow", **{**LM_NARROW, **kw})

    d = LM_NARROW["d_model"]
    return {
        "qwen3-1.7b": v(qk_norm=True, tie_embeddings=True),
        "qwen2-0.5b": v(n_kv_heads=1, qkv_bias=True, tie_embeddings=True),
        "nemotron-4-15b": v(act="squared_relu"),
        "qwen3-moe-30b-a3b": v(qk_norm=True, moe=MoEConfig(
            d_model=d, d_expert=64, n_experts=8, top_k=2,
            capacity_factor=2.0)),
        "deepseek-v3-671b": v(
            n_heads=4, n_kv_heads=4, n_dense_layers=1, mtp=True,
            mla=MLAConfig(d_model=d, n_heads=4, q_lora_rank=64,
                          kv_lora_rank=32, nope_head_dim=32,
                          rope_head_dim=16, v_head_dim=32),
            moe=MoEConfig(d_model=d, d_expert=64, n_experts=4, top_k=2,
                          n_shared=1, router_bias=True, capacity_factor=2.0)),
    }


def lm_layer_counts(cfg) -> tuple[int, int]:
    n_dense = cfg.n_dense_layers if cfg.moe is not None else cfg.n_layers
    return n_dense, cfg.n_layers - n_dense


def lm_ffn_params(cfg, moe_layer: bool, experts: int) -> int:
    """Weights one token's FFN reads: dense, or ``experts`` routed experts
    plus the shared ones and the router (0 for a MoE layer of a dense
    config: it has none)."""
    if moe_layer and cfg.moe is None:
        return 0
    if not moe_layer:
        return (3 if cfg.act == "swiglu" else 2) * cfg.d_model * cfg.d_ff
    m = cfg.moe
    return (experts + m.n_shared) * 3 * cfg.d_model * m.d_expert \
        + cfg.d_model * m.n_experts


def lm_prefill_flops(cfg, b: int, t: int) -> float:
    """The operations prefill of (b, t) tokens needs: every weight matmul
    of the layers at top_k experts a token, causal attention over the
    t(t+1)/2 (query, key) pairs each head sees, and the last position's
    logits. The GShard blocks' empty capacity slots are not counted."""
    n_dense, n_moe = lm_layer_counts(cfg)
    k = cfg.moe.top_k if cfg.moe else 0
    weights = (n_dense * lm_ffn_params(cfg, False, 0)
               + n_moe * lm_ffn_params(cfg, True, k)
               + cfg.n_layers * configs.lm_attn_params(cfg))
    if cfg.mla is not None:
        d_qk, d_v = cfg.mla.qk_head_dim, cfg.mla.v_head_dim
    else:
        d_qk = d_v = cfg.head_dim
    attn = cfg.n_layers * 2 * b * cfg.n_heads * (t * (t + 1) / 2) \
        * (d_qk + d_v)
    return 2 * b * t * weights + attn + 2 * b * cfg.d_model * cfg.vocab


def lm_decode_bytes(cfg, b: int, slots: float) -> float:
    """The bytes one decode step must move at ``slots`` valid cache slots:
    every weight it reads once (bf16; the float32 routers at 4 B), the
    valid cache, the token rows of an untied embedding. A MoE layer reads
    at most min(E, b * top_k) routed experts; the bound counts that many
    (this run's routing may reach fewer)."""
    n_dense, n_moe = lm_layer_counts(cfg)
    experts = min(cfg.moe.n_experts, b * cfg.moe.top_k) if cfg.moe else 0
    weights = 2 * (n_dense * lm_ffn_params(cfg, False, 0)
                   + n_moe * lm_ffn_params(cfg, True, experts)
                   + cfg.n_layers * configs.lm_attn_params(cfg)
                   + cfg.vocab * cfg.d_model)
    if cfg.moe is not None:          # the router is float32
        weights += n_moe * 2 * cfg.d_model * cfg.moe.n_experts
    if not cfg.tie_embeddings:
        weights += 2 * b * cfg.d_model
    per_slot = (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
                if cfg.mla is not None
                else 2 * cfg.n_kv_heads * cfg.head_dim)
    return weights + cfg.n_layers * b * slots * per_slot * 2


def _lm_tokens(cfg, b: int, t: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(1, cfg.vocab, (b, t)).astype(
        np.int32)).cuda()


def _lm_decode(params, cache, toks, t0: int, cfg) -> torch.Tensor:
    """LM_DECODE_STEPS steps from ``t0`` cached tokens, each fed the next
    token of ``toks`` (teacher forcing); their logits (B, steps, V)."""
    from repro_torch.models import lm
    out = []
    for i in range(LM_DECODE_STEPS):
        logits, cache = lm.decode_step(params, cache, toks[:, t0 + i],
                                       t0 + i, cfg)
        out.append(logits)
    return torch.stack(out, 1)


def _grown(cache: dict, slots: int) -> dict:
    """``cache`` (exactly T slots) padded with zero slots to ``slots``, in
    its dtype and on its device."""
    return {k: F.pad(v, [0, 0] * (v.ndim - 3) + [0, slots - v.shape[2]])
            for k, v in cache.items()}


def full_logits(params, cfg, toks, t0: int) -> torch.Tensor:
    """One forward over all of ``toks``: the logits at positions ``t0 - 1``
    .. ``t0 + LM_DECODE_STEPS - 1``, where prefill of ``t0`` tokens and the
    teacher-forced decode steps predict."""
    from repro_torch.models import lm
    with torch.inference_mode():
        hidden = lm.backbone(params, toks, cfg)
        return lm.logits_fn(params, hidden[:, t0 - 1:t0 + LM_DECODE_STEPS],
                            cfg)


def prefill_and_decode(params, cfg, toks, t0: int):
    """Prefill ``t0`` tokens of ``toks``, grow the cache to ``t0`` +
    LM_DECODE_STEPS slots and decode that many teacher-forced steps:
    (prefill logits, decode logits, the cache)."""
    from repro_torch.models import lm
    with torch.inference_mode():
        logits_p, cache = lm.prefill(params, toks[:, :t0], cfg)
        cache = _grown(cache, t0 + LM_DECODE_STEPS)
        return logits_p, _lm_decode(params, cache, toks, t0, cfg), cache


def lm_serve(name: str, cut: dict, b: int, card: str) -> dict:
    """One arch in bf16 on the card: prefill of (b, LM_SEQ), then
    LM_DECODE_STEPS teacher-forced decode steps over a cache of LM_SEQ +
    LM_DECODE_STEPS slots; times, tokens/s, peak memory and their bounds;
    the logits finite, and their drift from the full forward."""
    import dataclasses
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.LM_ARCHS[name], **cut)
    depth = ("full depth" if not cut else
             f"depth cut to {cfg.n_layers} of "
             f"{configs.LM_ARCHS[name].n_layers} layers"
             + (f" ({lm_layer_counts(cfg)[0]} dense + "
                f"{lm_layer_counts(cfg)[1]} MoE)" if cfg.moe else ""))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = lm.init(0, cfg, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree.leaves(params))
    p_bytes = sum(x.numel() * x.element_size() for x in tree.leaves(params))
    print(f"[lm] {name} on {card}: full width, {depth}: "
          f"{n_params / 1e9:.3f}B params, "
          f"{p_bytes / 1e9:.2f} GB in bf16 (float32 routers), drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    slots = LM_SEQ + LM_DECODE_STEPS
    toks = _lm_tokens(cfg, b, LM_FULL_SEQ, 1)
    with torch.inference_mode():
        prefill_ms = call_ms(lambda: lm.prefill(params, toks[:, :LM_SEQ],
                                                cfg), reps=2)
    logits_p, logits_d, cache = prefill_and_decode(params, cfg, toks, LM_SEQ)
    cache_gb = sum(c.numel() * c.element_size()
                   for c in cache.values()) / 1e9
    with torch.inference_mode():
        torch.cuda.synchronize()
        # the same steps again, timed: each writes the slot it wrote before
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _lm_decode(params, cache, toks, LM_SEQ, cfg)
        end.record()
        torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / LM_DECODE_STEPS
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    del cache
    flops = lm_prefill_flops(cfg, b, LM_SEQ)
    p_bound, p_by = bound_ms(0.0, flops, BF16_FLOPS)
    d_bytes = lm_decode_bytes(cfg, b, LM_SEQ + (LM_DECODE_STEPS + 1) / 2)
    d_bound, d_by = bound_ms(d_bytes, 0.0)
    out = dict(params_gb=p_bytes / 1e9, prefill_ms=prefill_ms,
               prefill_bound_ms=p_bound, prefill_tok_s=b * LM_SEQ
               / prefill_ms * 1e3, decode_ms=decode_ms,
               decode_bound_ms=d_bound, decode_tok_s=b / decode_ms * 1e3,
               cache_gb=cache_gb, peak_gb=peak_gb, batch=b,
               least_gb=p_bytes / 1e9 + cache_gb)
    print(f"[lm] {name} on {card}: prefill (B, T) = ({b}, {LM_SEQ}) "
          f"{prefill_ms:.1f} ms ({out['prefill_tok_s']:.0f} tokens/s; bound "
          f"{p_bound:.1f} ms by {p_by}: {flops:.3e} FLOP at 989 TFLOP/s); "
          f"decode {decode_ms:.2f} ms/step over a cache of {slots} slots, "
          f"{cache_gb:.2f} GB ({out['decode_tok_s']:.0f} tokens/s; bound "
          f"{d_bound:.2f} ms by {d_by}: {d_bytes / 1e9:.2f} GB at 3.35 "
          f"TB/s); peak device memory {peak_gb:.2f} GB above what was "
          f"there (least: the params and the decode cache, "
          f"{p_bytes / 1e9 + cache_gb:.2f} GB)")
    if not (torch.isfinite(logits_p).all() and torch.isfinite(logits_d).all()):
        raise AssertionError(f"{name}: non-finite bf16 logits")
    full = full_logits(params, cfg, toks, LM_SEQ)
    out["bf16_drift"] = (_rel(logits_p.float(), full[:, 0].float()),
                         _rel(logits_d.float(), full[:, 1:].float()))
    print(f"[lm] {name} on {card}: bf16 drift, measured (not held): "
          f"prefill logits vs "
          f"the full forward over {LM_FULL_SEQ} tokens "
          f"{out['bf16_drift'][0]:.3e}, decode {out['bf16_drift'][1]:.3e} "
          f"relative L2"
          + (" (at the config's capacity, which clips other assignments "
             "at each token count)" if cfg.moe else ""))
    del full
    del logits_p, logits_d
    out["params"] = params
    out["cfg"] = cfg
    return out


def lm_check(name: str, cfg, check: tuple, card: str) -> float:
    """The reference's decode-vs-full property (tests/test_models.py) at
    full width in float32 (fresh params, TF32 off): prefill, then
    LM_DECODE_STEPS teacher-forced decode steps, each logit within
    LM_CHECK_TOL of one forward over the whole sequence. MoE archs run it
    with capacity = tokens, as the reference's bisect test does."""
    import dataclasses
    from repro_torch.models import lm
    b, t0, t_full = check
    cfg = dataclasses.replace(cfg, mtp=False)      # decode has no MTP head
    if cfg.moe is not None:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
        print(f"[lm] {name}: the decode-vs-full check runs with "
              f"capacity_factor {cfg.moe.capacity_factor} (capacity = "
              f"tokens: nothing clipped); a finite capacity depends on the "
              f"tokens in the call (moe._cap_per_expert), so prefill, decode "
              f"and the full forward would clip different assignments by "
              f"design")
    params = lm.init(0, cfg, torch.float32, device="cuda")
    toks = _lm_tokens(cfg, b, t_full, 2)
    logits_p, logits_d, cache = prefill_and_decode(params, cfg, toks, t0)
    del cache
    full = full_logits(params, cfg, toks, t0)
    label = (f"{name} float32 on {card}, (B, T) = ({b}, {t0}) + "
             f"{LM_DECODE_STEPS} "
             f"steps vs a forward over {t_full} tokens")
    return max(compare(f"{label}: prefill logits", logits_p, full[:, 0],
                       LM_CHECK_TOL),
               compare(f"{label}: decode logits", logits_d, full[:, 1:],
                       LM_CHECK_TOL))


def lm_train_deepseek(params, cfg, card: str) -> dict:
    """deepseek's train_loss with its MTP head at full width (the cut
    depth): loss and every gradient, at LM_TRAIN_SHAPE."""
    from repro_torch.models import lm
    b, t = LM_TRAIN_SHAPE
    toks = _lm_tokens(cfg, b, t + 1, 3)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    p_gb = sum(x.numel() * x.element_size()
               for x in tree.leaves(params)) / 1e9
    print(f"[lm] deepseek train_loss reckoned peak: {p_gb:.1f} GB of "
          f"params + {p_gb:.1f} GB of bf16 gradients + activations at "
          f"(B, T) = ({b}, {t})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = _grads(lambda q: lm.train_loss(q, batch, cfg), params)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    n_zero = sum(int(not g.any()) for g in grads)
    del grads
    ms = call_ms(lambda: _grads(lambda q: lm.train_loss(q, batch, cfg),
                                params), reps=2)
    print(f"[lm] deepseek train_loss (MTP on) forward + backward at (B, T) "
          f"= ({b}, {t}) on {card}: loss {float(loss):.4f}, {ms:.1f} ms per "
          f"call, peak device memory {peak:.2f} GB; {n_zero} gradient "
          f"tensors all zero (the router bias only picks experts)")
    if not finite:
        raise AssertionError("deepseek train_loss: non-finite loss or "
                             "gradient")
    return dict(ms=ms, peak_gb=peak, loss=float(loss))


def lm_card_vs_cpu(card: str) -> float:
    """The narrow variants, f32 params drawn on the CPU and copied to the
    card: prefill logits, one decode step's logits, train_loss and every
    gradient, card against CPU (TF32 off)."""
    from repro_torch.models import lm
    worst = 0.0
    cuda = torch.device("cuda")
    for name, cfg in lm_narrow_configs().items():
        params = lm.init(0, cfg, device="cpu")
        pc = _to(params, cuda)
        rng = np.random.default_rng(4)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, LM_NARROW_SEQ + 1)).astype(np.int32))
        tc = toks.to(cuda)
        t = LM_NARROW_SEQ                   # chunkable: the flash path
        with torch.inference_mode():
            got, cache = lm.prefill(pc, tc[:, :t], cfg)
            want, ccache = lm.prefill(params, toks[:, :t], cfg)
            worst = max(worst, compare(f"lm {name} narrow prefill logits, "
                                       f"{card} vs CPU", got, want.to(cuda),
                                       RECSYS_TOL))
            got, _ = lm.decode_step(pc, _grown(cache, t + 1), tc[:, t], t, cfg)
            want, _ = lm.decode_step(params, _grown(ccache, t + 1),
                                     toks[:, t], t, cfg)
            worst = max(worst, compare(f"lm {name} narrow decode logits, "
                                       f"{card} vs CPU", got, want.to(cuda),
                                       RECSYS_TOL))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        bc = {k: v.to(cuda) for k, v in batch.items()}
        loss, g_got = _grads(lambda q: lm.train_loss(q, bc, cfg), pc)
        wloss, g_want = _grads(lambda q: lm.train_loss(q, batch, cfg), params)
        compare(f"lm {name} narrow train_loss, {card} vs CPU", loss,
                wloss.to(cuda), RECSYS_TOL)
        check_tensors(f"lm {name} narrow gradients, {card} vs CPU", g_got,
                      [g.to(cuda) for g in g_want], RECSYS_GRAD_REL_L2)
    return worst


def attn_inputs(shape: dict, dtype: torch.dtype, gen: torch.Generator
                ) -> tuple[torch.Tensor, ...]:
    """q, k, v and an output gradient at ``shape``; v a split view of a
    wider tensor where ``split_v`` (MLA's)."""
    b, t, h, kv, d = (shape[x] for x in ("b", "t", "h", "kv", "d"))
    s, dv = shape.get("s", t), shape.get("dv", d)

    def rnd(*size):
        return torch.randn(size, generator=gen, device="cuda", dtype=dtype)

    q, k = rnd(b, t, h, d), rnd(b, s, kv, d)
    v = (rnd(b, s, kv, 128 + dv).split([128, dv], -1)[1]
         if shape.get("split_v") else rnd(b, s, kv, dv))
    return q, k, v, rnd(b, t, h, dv)


def attn_args(shape: dict) -> tuple:
    """(q_start, causal, q_chunk, kv_chunk, scale) as the LM calls it."""
    t, s = shape["t"], shape.get("s", shape["t"])
    return (shape.get("q_start", s - t), True, min(512, t), min(1024, s),
            shape["d"] ** -0.5)


def attn_work(shape: dict, esize: int) -> dict[str, tuple[float, float]]:
    """(bytes, operations) the forward and the backward must move and do:
    each input read once and each output written once (lse in f32), and 2
    per multiply-add of each product over the (query, key) pairs causal
    masking leaves (forward: q.k and p.v; backward: the q.k recompute,
    dv, dp, dq and dk)."""
    b, t, h, kv, d = (shape[x] for x in ("b", "t", "h", "kv", "d"))
    s, dv = shape.get("s", t), shape.get("dv", d)
    q_start = attn_args(shape)[0]
    pos = q_start + np.arange(t)
    pairs = b * h * float(np.clip(pos + 1, 0, s).sum())
    q_el, k_el, o_el = b * t * h * d, b * s * kv * (d + dv), b * t * h * dv
    lse = 4.0 * b * t * h
    return {"fwd": ((q_el + k_el + o_el) * esize + lse,
                    2 * pairs * (d + dv)),
            "bwd": ((2 * q_el + 2 * k_el + 2 * o_el) * esize + lse,
                    2 * pairs * (3 * d + 2 * dv))}


def sdpa(q, k, v):
    """``F.scaled_dot_product_attention`` on the LM's (B, T, H, d) layout:
    the library call ``flash_attention`` is timed against (a yardstick the
    port never calls)."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


def phase_attention_check(gen: torch.Generator) -> dict[str, float]:
    """flash attention's kernel against its plain version on the card,
    forward (out, lse) and backward (dq, dk, dv), float32 and bf16, at
    ATTN_SHAPE, MLA_SHAPE and CP_SHAPE, and float32 at LM100M_ATTN_SHAPE
    (lm-100m's training). Returns the float32 max abs errors at
    ATTN_SHAPE."""
    err = {}
    both = (torch.float32, torch.bfloat16)
    for label, shape, dtypes in (
            ("qwen3-1.7b prefill", ATTN_SHAPE, both),
            ("deepseek-v3 MLA", MLA_SHAPE, both),
            ("context-parallel block", CP_SHAPE, both),
            ("lm-100m train", LM100M_ATTN_SHAPE, (torch.float32,))):
        for dtype in dtypes:
            q, k, v, dout = attn_inputs(shape, dtype, gen)
            args = attn_args(shape)
            out, lse = flash_attention_fwd(q, k, v, *args)
            grads = flash_attention_bwd(q, k, v, out, lse, dout, *args)
            w_out, w_lse = ops.attn_fwd_ref(q, k, v, *args)
            w_grads = ops.attn_bwd_ref(q, k, v, w_out, w_lse, dout, *args)
            way = fa_route(dtype, fa_bucket(q.shape[3], v.shape[3]))[0]
            tag = (f"flash_attention {str(dtype)[6:]} ({way}) {label} (B, T, "
                   f"S, H, KV, dqk, dv) = ({q.shape[0]}, {q.shape[1]}, "
                   f"{k.shape[1]}, {q.shape[2]}, {k.shape[2]}, "
                   f"{q.shape[3]}, {v.shape[3]}), q_start {args[0]}")
            if dtype == torch.float32:
                e_f = max(compare(f"{tag}: out", out, w_out, ATTN_F32_OUT_TOL),
                          compare(f"{tag}: lse", lse, w_lse,
                                  ATTN_F32_OUT_TOL))
                e_b = max(compare(f"{tag}: {n}", g, w, ATTN_F32_GRAD_TOL)
                          for n, g, w in zip(("dq", "dk", "dv"), grads,
                                             w_grads, strict=True))
                if shape is ATTN_SHAPE:
                    err["flash_attention_fwd"] = e_f
                    err["flash_attention_bwd"] = e_b
            else:
                check_tensors(f"{tag}: out", [out], [w_out], LM_ATTN_REL_L2)
                check_tensors(f"{tag}: dq, dk, dv", list(grads),
                              list(w_grads), LM_ATTN_REL_L2)
            del q, k, v, dout, out, lse, grads, w_out, w_lse, w_grads
            gc.collect()
            torch.cuda.empty_cache()
    return err


def attn_times(shape: dict, dtype: torch.dtype, gen: torch.Generator,
               card: str) -> dict:
    """The kernel's forward, backward alone and both at ``shape`` beside
    the plain version's, SDPA's and the bounds (ms)."""
    q, k, v, dout = attn_inputs(shape, dtype, gen)
    args = attn_args(shape)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    work = attn_work(shape, q.element_size())
    out = {}
    with torch.no_grad():
        o, lse = flash_attention_fwd(q, k, v, *args)
        w_o, w_lse = ops.attn_fwd_ref(q, k, v, *args)
        reps = 3 if dtype == torch.bfloat16 else 1
        out["ms"] = dict(
            fwd=call_ms(lambda: flash_attention_fwd(q, k, v, *args), reps=5),
            bwd=call_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dout,
                                                    *args), reps=reps),
            both=call_ms(lambda: flash_attention_bwd(
                q, k, v, *flash_attention_fwd(q, k, v, *args), dout, *args),
                reps=reps))
        out["plain_ms"] = dict(
            fwd=call_ms(lambda: ops.attn_fwd_ref(q, k, v, *args), reps=2),
            bwd=call_ms(lambda: ops.attn_bwd_ref(q, k, v, w_o, w_lse, dout,
                                                 *args), reps=1),
            both=call_ms(lambda: ops.attn_bwd_ref(
                q, k, v, *ops.attn_fwd_ref(q, k, v, *args), dout, *args),
                reps=1))
        del o, lse, w_o, w_lse
    try:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        with torch.no_grad():
            lib_fwd = call_ms(lambda: sdpa(q, k, v), reps=5)
        lib_out = sdpa(*leaves)
        out["library_ms"] = dict(
            fwd=lib_fwd,
            bwd=call_ms(lambda: torch.autograd.grad(
                lib_out, leaves, dout, retain_graph=True), reps=3),
            both=call_ms(lambda: torch.autograd.grad(
                sdpa(*leaves), leaves, dout), reps=3))
        del lib_out, leaves
    except RuntimeError as e:     # a yardstick only: none takes this shape
        out["library_ms"] = dict(fwd=None, bwd=None, both=None)
        print(f"[lm] F.scaled_dot_product_attention does not take "
              f"{str(dtype)[6:]} {shape}: {str(e).splitlines()[0]}")
    bounds = {p: bound_ms(*work[p], peak) for p in ("fwd", "bwd")}
    out["bound_ms"] = dict(fwd=bounds["fwd"][0], bwd=bounds["bwd"][0],
                           both=bounds["fwd"][0] + bounds["bwd"][0])
    out["bound_by"] = bounds["fwd"][1]
    out["flops"] = dict(fwd=work["fwd"][1], bwd=work["bwd"][1])

    def fmt(x):
        return "n/a" if x is None else f"{x:.3f}"

    print(f"[lm] flash attention {str(dtype)[6:]} (B, T, S, H, KV, dqk, dv) "
          f"= ({q.shape[0]}, {q.shape[1]}, {k.shape[1]}, {q.shape[2]}, "
          f"{k.shape[2]}, {q.shape[3]}, {v.shape[3]}), causal, on {card}: "
          + "; ".join(
              f"{p} kernel {out['ms'][p]:.3f} ms, plain "
              f"{out['plain_ms'][p]:.3f}, SDPA {fmt(out['library_ms'][p])}, "
              f"bound {out['bound_ms'][p]:.3f}"
              for p in ("fwd", "bwd", "both"))
          + f" (by {out['bound_by']}: {work['fwd'][1]:.3e} / "
          f"{work['bwd'][1]:.3e} FLOP at {peak / 1e12:.0f} TFLOP/s)")
    return out


def lm_attention_yardstick(card: str) -> dict:
    """flash attention on the card (not counted: the main path's launches
    are read before): its times at ATTN_SHAPE in bf16 and float32, at
    MLA_SHAPE in bf16 and at LM100M_ATTN_SHAPE in float32 (the shape
    lm-100m's training launches), each beside the plain version, SDPA and
    the bound;
    and the kernel's bf16 forward and gradients against SDPA's at
    ATTN_SHAPE."""
    from repro_torch.models.attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, dout = attn_inputs(ATTN_SHAPE, torch.bfloat16, gen)
    leaves = [x.requires_grad_() for x in (q, k, v)]

    def fwd_bwd(fn):
        out = fn(*leaves)
        return [out.detach(), *torch.autograd.grad(out, leaves, dout)]

    err = check_tensors("flash_attention forward, dq, dk, dv vs SDPA's, bf16",
                        fwd_bwd(flash_attention), fwd_bwd(sdpa),
                        LM_ATTN_REL_L2)
    del q, k, v, dout, leaves
    out = {"bf16": attn_times(ATTN_SHAPE, torch.bfloat16, gen, card),
           "f32": attn_times(ATTN_SHAPE, torch.float32, gen, card),
           "mla": attn_times(MLA_SHAPE, torch.bfloat16, gen, card),
           "f32_lm100m": attn_times(LM100M_ATTN_SHAPE, torch.float32, gen,
                                    card),
           "sdpa_err": err}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def attention_record(att: dict, err: dict[str, float],
                     launches: dict[str, int],
                     routes: dict[str, dict[str, dict[str, int]]],
                     build: dict) -> dict:
    """The kernel's record for the ``kernels`` line: the forward at
    ATTN_SHAPE in bf16 (the LM's dtype), its backward as the entry, each
    with its float32 times at ATTN_SHAPE and LM100M_ATTN_SHAPE and its MLA
    times, its launches by route on each LM path
    (``routes``: path -> wrapper -> route -> launches), and the build
    phase's seconds and its SASS's HGMMA count by shape."""
    src = dict(route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/models/attention.py:120",
               replaces_what="_flash_attention and its custom_vjp, plain "
                             "jnp (no pl.pallas_call): the one LM function "
                             "the port ran as a plain chunk loop",
               library_note="F.scaled_dot_product_attention (is_causal, "
                            "enable_gqa): a yardstick the port never calls")

    def part(p: str) -> dict:
        b = att["bf16"]
        return dict(ms=b["ms"][p], plain_ms=b["plain_ms"][p],
                    bound_ms=b["bound_ms"][p], bound_by=b["bound_by"],
                    library_ms=b["library_ms"][p],
                    f32={k: att["f32"][k][p] for k in
                         ("ms", "plain_ms", "library_ms", "bound_ms")},
                    f32_lm100m={k: att["f32_lm100m"][k][p] for k in
                                ("ms", "plain_ms", "library_ms",
                                 "bound_ms")},
                    mla={k: att["mla"][k][p] for k in
                         ("ms", "plain_ms", "library_ms", "bound_ms")})

    def by_route(entry: str) -> dict:
        return {path: r[entry] for path, r in routes.items()}

    rec = dict(name="flash_attention", entry="flash_attention_fwd", **src,
               launches=launches["flash_attention_fwd"],
               max_abs_err=err["flash_attention_fwd"], **part("fwd"),
               shape=dict(ATTN_SHAPE), mla_shape=dict(MLA_SHAPE),
               f32_lm100m_shape=dict(LM100M_ATTN_SHAPE),
               fwd_bwd=part("both"), sdpa_rel_l2=att["sdpa_err"],
               launches_by_route=by_route("flash_attention_fwd"), **build)
    rec["entries"] = [dict(name="flash_attention", entry="flash_attention_bwd",
                           **src, launches=launches["flash_attention_bwd"],
                           max_abs_err=err["flash_attention_bwd"],
                           launches_by_route=by_route("flash_attention_bwd"),
                           **part("bwd"))]
    return rec


def lm_layers(card: str) -> dict:
    """The LM path's other layers alone, each beside its bound: the MoE
    FFN at qwen3-moe's width over a prefill's tokens (and its blocked
    GEMMs alone, the rest being dispatch and combine), ``chunked_ce``
    forward and backward at lm-100m's (LM_TRAIN_BATCH, 256), and decode
    attention over qwen3-1.7b's cache of one layer."""
    import dataclasses
    from repro_torch.models import lm, moe
    from repro_torch.models.attention import decode_attention
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    # MoE at qwen3-moe-30b-a3b's width, (8, 4096) tokens, capacity 1.5
    m = configs.QWEN3_MOE_30B_A3B_MOE
    p = moe.init_moe(gen, m, torch.bfloat16)
    n = 8 * LM_SEQ
    x = torch.randn((n, m.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    cap = moe._cap_per_expert(m, n)
    xb = torch.randn((m.n_experts, cap, m.d_model), generator=gen,
                     device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        out["moe_ffn"] = call_ms(lambda: moe.moe_ffn(p, x, m))
        out["moe blocked GEMMs"] = call_ms(lambda: moe._blocked_ffn(
            xb, p["w_gate"], p["w_up"], p["w_down"], m.act))
    flops = 2 * n * m.top_k * 3 * m.d_model * m.d_expert
    w_bytes = 3 * m.n_experts * m.d_model * m.d_expert * 2
    moe_bound, moe_by = bound_ms(w_bytes + 2 * n * m.d_model * 2, flops,
                                 BF16_FLOPS)
    print(f"[lm] moe_ffn at qwen3-moe width, {n} tokens, top-{m.top_k} of "
          f"{m.n_experts}, capacity {cap}, bf16, on {card}: "
          f"{out['moe_ffn']:.3f} ms, of which the blocked GEMMs alone "
          f"{out['moe blocked GEMMs']:.3f} ms (the rest: routing, sort, "
          f"dispatch and combine); bound {moe_bound:.3f} ms by {moe_by}")
    del p, x, xb
    # chunked_ce, forward and backward, lm-100m (f32, padded to 512)
    cfg = configs.LM_100M
    params = lm.init(0, cfg, device="cuda")
    b, t = LM_TRAIN_BATCH, 256
    hidden = torch.randn((b, t, cfg.d_model), generator=gen, device="cuda",
                         requires_grad=True)
    tgt = torch.randint(0, cfg.vocab, (b, t), generator=gen, device="cuda")

    def ce():
        loss = lm.chunked_ce(params, hidden, tgt, cfg)
        return torch.autograd.grad(loss, (hidden, params["embed"]))

    params["embed"].requires_grad_()
    out["chunked_ce"] = call_ms(ce, reps=3)
    ce_flops = 3 * 2 * b * t * cfg.d_model * cfg.vocab
    ce_bound, ce_by = bound_ms(0.0, ce_flops)
    print(f"[lm] chunked_ce forward + backward at lm-100m, (B, T) = ({b}, "
          f"{t}) padded to 512, vocab {cfg.vocab}, f32, on {card}: "
          f"{out['chunked_ce']:.3f} ms; bound {ce_bound:.3f} ms by {ce_by} "
          f"({ce_flops:.3e} FLOP for the {t} real positions at 67 TFLOP/s)")
    del params, hidden
    # decode attention over one layer of qwen3-1.7b's cache
    c = configs.QWEN3_1_7B
    slots = LM_SEQ + LM_DECODE_STEPS
    q = torch.randn((8, c.n_heads, c.head_dim), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kc = torch.randn((8, slots, c.n_kv_heads, c.head_dim), generator=gen,
                     device="cuda", dtype=torch.bfloat16)
    vc = torch.randn_like(kc)
    with torch.inference_mode():
        out["decode_attention"] = call_ms(
            lambda: decode_attention(q, kc, vc, slots), reps=20)
    da_bound, da_by = bound_ms(2 * kc.numel() * 2, 0.0)
    print(f"[lm] decode_attention over one layer's cache of qwen3-1.7b "
          f"(8 x {slots} slots, {c.n_kv_heads} KV heads, d {c.head_dim}), "
          f"bf16, on {card}: {out['decode_attention']:.3f} ms; bound "
          f"{da_bound:.3f} ms by {da_by}")
    return dict(ms=out, bound_ms=dict(moe_ffn=moe_bound, chunked_ce=ce_bound,
                                      decode_attention=da_bound))


def _lm_100m_steps(b: int, card: str) -> dict:
    """launch/train.py's LM pipeline in process at (b, 256): one cold and
    three warm steps, the warm median, the loss, the peak memory."""
    import argparse
    args = argparse.Namespace(seed=0, lr=1e-3, batch=b, seq_len=256,
                              device="cuda")
    params, opt, loss_fn, batch_fn = train_mod._lm_pipeline(args)
    step = train_mod.make_step(opt, loss_fn)
    state = (params, opt.init(params), None)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(4):
        batch = batch_fn(i)
        t0 = time.perf_counter()
        state = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = dict(batch=b, step_ms=_median(times[1:]), cold_ms=times[0],
               loss=float(state[2]),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[lm] lm-100m train step at (batch, seq) = ({b}, 256) on {card}: "
          f"{out['step_ms']:.1f} ms (median of 3 warm; cold "
          f"{out['cold_ms']:.1f}), loss {out['loss']:.4f}, peak device "
          f"memory {out['peak_gb']:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}")
    if not np.isfinite(out["loss"]):
        raise AssertionError("lm-100m: non-finite loss")
    return out


def lm_train_100m(card: str) -> dict:
    """launch/train.py's LM pipeline (lm-100m, AdamW) on the card: in
    process at the CLI's defaults (batch 256, seq 256), which may not fit
    (the run says so), and at LM_TRAIN_BATCH; then the CLI itself at
    LM_TRAIN_BATCH, run and resumed."""
    try:
        defaults = _lm_100m_steps(LM_CLI_BATCH, card)
    except torch.OutOfMemoryError as e:
        # a measurement: the defaults' peak exceeds the card
        defaults = None
        print(f"[lm] lm-100m at the CLI's defaults (batch {LM_CLI_BATCH}, "
              f"seq 256) does not fit one card: {str(e).splitlines()[0]}")
    # outside the handler, where the failed step's tensors are free
    gc.collect()
    torch.cuda.empty_cache()
    b = LM_TRAIN_BATCH
    out = _lm_100m_steps(b, card)
    out["defaults"] = defaults
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    try:
        outs = []
        for steps in (4, 6):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--model",
                 "lm", "--steps", str(steps), "--batch", str(b),
                 "--seq-len", "256", "--ckpt-every", "2", "--log-every", "1",
                 "--ckpt-dir", ckpt_dir, "--device", "cuda"], env=env,
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            for line in r.stdout.splitlines():
                print(f"[cli --model lm --steps {steps}] {line}")
            if r.returncode:
                raise AssertionError(f"the LM training CLI failed:\n"
                                     f"{r.stderr[-3000:]}")
            print(f"[cli --model lm --steps {steps}] "
                  f"{time.perf_counter() - t0:.1f} s in all")
            outs.append(r.stdout)
        resumed_at = checkpoint.latest_step(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not ("final loss" in outs[0] and outs[0].count("\nstep ") == 4
            and "final loss" in outs[1] and outs[1].count("\nstep ") == 2
            and resumed_at == 6):
        raise AssertionError("the LM CLI did not train 4 steps and then "
                             "resume for 2 more")
    return out


def phase_lm(card: str) -> dict:
    """The LM family on the card, its attention through the flash
    attention kernel (forward and backward) and no DLRM kernel: the five
    archs in bf16 at full width (qwen3-1.7b at full depth), each decode
    held against its full forward; deepseek's train_loss with MTP; the
    narrow variants card against CPU; lm-100m training and its CLI; then,
    not counted, the attention yardstick and the other layers alone."""
    reset_counts()
    print(f"[lm] device memory held by earlier phases on {card}: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    out: dict = {"archs": {}}
    # first, while the allocator holds nothing: its peak is near the card's
    out["train"] = lm_train_100m(card)
    for name, cut, b, check in LM_RUNS:
        res = lm_serve(name, cut, b, card)
        params, cfg = res.pop("params"), res.pop("cfg")
        if name == "deepseek-v3-671b":
            out["deepseek_train"] = lm_train_deepseek(params, cfg, card)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        res["err"] = lm_check(name, cfg, check, card)
        out["archs"][name] = res
        gc.collect()
        torch.cuda.empty_cache()
    out["card_vs_cpu"] = lm_card_vs_cpu(card)
    torch.cuda.synchronize()
    launches, routes = read_counts(), read_routes()
    # qwen3-1.7b's serve alone, bf16 (the wgmma route): three timed
    # prefills, prefill_and_decode's and the full forward, each through
    # every layer; lm-100m's in-process steps at LM_TRAIN_BATCH in float32
    # (the cuda_cores route), two backward launches a layer a step;
    # deepseek's bf16 train_loss, two a layer
    n_qwen = configs.LM_ARCHS["qwen3-1.7b"].n_layers
    check_lm_launches("lm", launches, routes, fwd=5 * n_qwen,
                      bwd=2 * 4 * configs.LM_100M.n_layers,
                      wgmma_fwd=5 * n_qwen, wgmma_bwd=2,
                      cc_bwd=2 * 4 * configs.LM_100M.n_layers)
    out["launches"], out["routes"] = launches, routes
    out["attention"] = lm_attention_yardstick(card)
    out["layers"] = lm_layers(card)
    return out


# the lm_mesh phase: the LM's plans on a (1, 1) NCCL mesh against the same
# plans without one, bf16 at full width with the depth the lm phase cuts;
# held at the bf16 tolerance of the LM's parity tests (tests/test_torch_lm.py
# BF16_TOL; at world size 1 both sides run the same ops, so 0 is expected)
LM_MESH_TOL = dict(rtol=2e-2, atol=2e-2)
LM_MESH_RUNS = (
    ("qwen3-moe-30b-a3b", dict(n_layers=2), 8),
    ("deepseek-v3-671b", dict(n_layers=2, n_dense_layers=1), 2),
)
LM_MESH_TRAIN = ("qwen2-0.5b", dict(n_layers=2), 8)


def _cut_bundle(name: str, cut: dict):
    """``name``'s registry bundle with its config's depth cut."""
    import dataclasses
    import functools
    from repro_torch.models import lm
    bundle = configs.get_arch(name)
    cfg = dataclasses.replace(bundle.cfg, **cut)
    return dataclasses.replace(bundle, cfg=cfg,
                               init=functools.partial(lm.init, cfg=cfg))


def _chunked_moe_ffn(chunk: int):
    """``moe.moe_ffn`` applied ``chunk`` rows at a time where the rows are
    more and divide: what the reference's 2D prefill with ``token_chunk``
    computes on one device."""
    from repro_torch.models import moe
    whole = moe.moe_ffn

    def fn(params, x, cfg):
        x2d = x.reshape(-1, cfg.d_model)
        n = x2d.shape[0]
        if n <= chunk or n % chunk:
            return whole(params, x, cfg)
        return torch.cat([whole(params, x2d[lo:lo + chunk], cfg)
                          for lo in range(0, n, chunk)]).reshape(x.shape)
    return fn


def _calls(mesh, fn, per: int = 1) -> dict:
    """``fn()``'s collectives by kind (divided by ``per``)."""
    mesh.calls.clear()
    out = fn()
    torch.cuda.synchronize()
    calls = {k: v / per for k, v in sorted(mesh.calls.items())}
    return out, calls


def lm_mesh_serve(mesh, name: str, cut: dict, b: int, card: str) -> dict:
    """``name``'s prefill and decode plans under ``mesh`` against the same
    plans without a mesh: prefill of (b, LM_SEQ), then LM_DECODE_STEPS
    teacher-forced decode steps over LM_SEQ + LM_DECODE_STEPS slots; the
    logits and caches held, the times and collectives printed."""
    import contextlib
    from unittest import mock

    from repro_torch.models import lm, moe
    bundle = _cut_bundle(name, cut)
    cfg = bundle.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(0, cfg, torch.bfloat16, device="cuda")
    toks = _lm_tokens(cfg, b, LM_SEQ + LM_DECODE_STEPS, 7)
    pre, dec = bundle.steps["prefill_32k"], bundle.steps["decode_32k"]
    plans = {k: (pre.make_fn(bundle, m, False).fn,
                 dec.make_fn(bundle, m, False).fn)
             for k, m in (("mesh", mesh), ("mesh-free", None))}
    chunk = pre.make_fn.keywords.get("ep_token_chunk")
    layout = ("2D EP, token_chunk %d" % chunk if chunk else
              "2D EP" if pre.make_fn.keywords.get("ep_2d") else "sharded EP")
    out, ms, calls = {}, {}, {}
    with torch.inference_mode():
        for k, (prefill, decode) in plans.items():
            # without a mesh, the chunked prefill's MoE over the same chunks
            chunked = (mock.patch.object(moe, "moe_ffn",
                                         _chunked_moe_ffn(chunk))
                       if chunk and k == "mesh-free"
                       else contextlib.nullcontext())
            with chunked:
                (logits, cache), c = _calls(
                    mesh, lambda prefill=prefill: prefill(
                        params, toks[:, :LM_SEQ]))
                ms[k, "prefill"] = call_ms(lambda prefill=prefill: prefill(
                    params, toks[:, :LM_SEQ]), reps=2)
            calls[k, "prefill"] = c
            cache = _grown(cache, LM_SEQ + LM_DECODE_STEPS)

            def steps(decode=decode, cache=cache):
                return torch.stack([decode(params, cache, toks[:, LM_SEQ + i],
                                           length=LM_SEQ + i)[0]
                                    for i in range(LM_DECODE_STEPS)], 1)
            dlogits, c = _calls(mesh, steps, LM_DECODE_STEPS)
            calls[k, "decode"] = c
            out[k] = (logits, dlogits, cache)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            steps()          # the same steps again: each rewrites its slot
            end.record()
            torch.cuda.synchronize()
            ms[k, "decode"] = start.elapsed_time(end) / LM_DECODE_STEPS
    peak = torch.cuda.max_memory_allocated() / 1e9
    label = f"{name} ({layout} prefill), bf16 on {card}"
    errs = [compare(f"lm_mesh {label}: prefill logits, mesh vs mesh-free",
                    out["mesh"][0], out["mesh-free"][0], LM_MESH_TOL),
            compare(f"lm_mesh {label}: {LM_DECODE_STEPS} decode steps' "
                    f"logits, mesh vs mesh-free", out["mesh"][1],
                    out["mesh-free"][1], LM_MESH_TOL)]
    for key in out["mesh"][2]:
        errs.append(compare(f"lm_mesh {label}: cache {key!r} after decode, "
                            f"mesh vs mesh-free", out["mesh"][2][key],
                            out["mesh-free"][2][key], LM_MESH_TOL))
    if not all(torch.isfinite(x).all() for x in out["mesh"][:2]):
        raise AssertionError(f"{name}: non-finite logits under the mesh")
    depth = (f"{lm_layer_counts(cfg)[0]} dense + {lm_layer_counts(cfg)[1]} "
             f"MoE of {configs.LM_ARCHS[name].n_layers} layers")
    print(f"[lm_mesh] {name} at full width, {depth}, on {card}: prefill "
          f"(B, T) = ({b}, {LM_SEQ}) mesh / mesh-free "
          f"{ms['mesh', 'prefill']:.1f} / {ms['mesh-free', 'prefill']:.1f} ms, "
          f"collectives per prefill {calls['mesh', 'prefill']}; decode over "
          f"{LM_SEQ + LM_DECODE_STEPS} slots {ms['mesh', 'decode']:.2f} / "
          f"{ms['mesh-free', 'decode']:.2f} ms/step, collectives per step "
          f"{calls['mesh', 'decode']}; peak device memory {peak:.2f} GB")
    del params, out, plans
    return dict(ms={f"{k} {p}": v for (k, p), v in ms.items()},
                calls={p: calls["mesh", p] for p in ("prefill", "decode")},
                peak_gb=peak, err=max(errs), layout=layout)


def lm_mesh_train(mesh, card: str) -> dict:
    """qwen2-0.5b (context-parallel attention) cut in depth: prefill of
    (b, LM_SEQ) and one step of its train plan at (b, LM_SEQ) with
    ``seq_shard`` (forward, backward, the data-parallel sum, AdamW) under
    ``mesh`` against the same plans without one: logits, cache, loss, every
    gradient and every updated param."""
    from repro_torch.models import lm
    name, cut, b = LM_MESH_TRAIN
    bundle = _cut_bundle(name, cut)
    cfg = bundle.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(0, cfg, torch.bfloat16, device="cuda")
    toks = _lm_tokens(cfg, b, LM_SEQ + 1, 8)
    pre = {k: bundle.steps["prefill_32k"].make_fn(bundle, m, False).fn
           for k, m in (("mesh", mesh), ("mesh-free", None))}
    train = {k: bundle.steps["train_4k"].make_fn(bundle, m, False,
                                                 seq_shard=True)
             for k, m in (("mesh", mesh), ("mesh-free", None))}
    nmb = train["mesh"].args[2]["tokens"].shape[0]   # the microbatches
    batch = {"tokens": toks[:, :-1].reshape(nmb, b // nmb, LM_SEQ),
             "targets": toks[:, 1:].reshape(nmb, b // nmb, LM_SEQ)}
    out, ms, calls = {}, {}, {}
    with torch.inference_mode():
        for k, fn in pre.items():
            out[k, "prefill"], calls[k, "prefill"] = _calls(
                mesh, lambda fn=fn: fn(params, toks[:, :LM_SEQ]))
            ms[k, "prefill"] = call_ms(lambda fn=fn: fn(
                params, toks[:, :LM_SEQ]), reps=2)
    opt_state = bundle.optimizer.init(params)
    for k, plan in train.items():
        out[k, "grads"], calls[k, "grads"] = _calls(
            mesh, lambda plan=plan: plan.grads(params, batch))
        out[k, "step"], calls[k, "step"] = _calls(
            mesh, lambda plan=plan: plan.fn(params, opt_state, batch))
        ms[k, "step"] = call_ms(lambda plan=plan: plan.fn(
            params, opt_state, batch), reps=2)
    peak = torch.cuda.max_memory_allocated() / 1e9
    label = f"{name} (context-parallel), bf16 on {card}"
    errs = [compare(f"lm_mesh {label}: prefill logits, mesh vs mesh-free",
                    out["mesh", "prefill"][0], out["mesh-free", "prefill"][0],
                    LM_MESH_TOL)]
    for key in out["mesh", "prefill"][1]:
        errs.append(compare(f"lm_mesh {label}: prefill cache {key!r}",
                            out["mesh", "prefill"][1][key],
                            out["mesh-free", "prefill"][1][key], LM_MESH_TOL))
    errs.append(compare(f"lm_mesh {label}: train step loss (seq_shard)",
                        out["mesh", "grads"][0], out["mesh-free", "grads"][0],
                        LM_MESH_TOL))
    check_tensors(f"lm_mesh {label}: every gradient, mesh vs mesh-free",
                  tree.leaves(out["mesh", "grads"][1]),
                  tree.leaves(out["mesh-free", "grads"][1]), BF16_GRAD_REL_L2)
    check_tensors(f"lm_mesh {label}: every param after the AdamW step, mesh "
                  f"vs mesh-free", tree.leaves(out["mesh", "step"][0]),
                  tree.leaves(out["mesh-free", "step"][0]), BF16_GRAD_REL_L2)
    def max_abs(got, want) -> float:
        return max(float((a.float() - w.float()).abs().max())
                   for a, w in zip(tree.leaves(got), tree.leaves(want),
                                   strict=True))

    grad_err = max_abs(out["mesh", "grads"][1], out["mesh-free", "grads"][1])
    upd_err = max_abs(out["mesh", "step"][0], out["mesh-free", "step"][0])
    # the floor: the mesh-free gradients against a second run of
    # themselves (the card's backward need not be deterministic)
    floor = max_abs(train["mesh-free"].grads(params, batch)[1],
                    out["mesh-free", "grads"][1])
    print(f"[lm_mesh] {name} at full width, 2 of "
          f"{configs.LM_ARCHS[name].n_layers} layers, on {card}: prefill "
          f"(B, T) = ({b}, {LM_SEQ}) mesh / mesh-free "
          f"{ms['mesh', 'prefill']:.1f} / {ms['mesh-free', 'prefill']:.1f} ms, "
          f"collectives per prefill {calls['mesh', 'prefill']}; train step "
          f"({nmb} microbatches of {b // nmb} x {LM_SEQ}, seq_shard, AdamW) "
          f"{ms['mesh', 'step']:.1f} / {ms['mesh-free', 'step']:.1f} ms, "
          f"collectives per step {calls['mesh', 'step']}; gradients max abs "
          f"err {grad_err:.3e} (mesh-free against a second mesh-free run: "
          f"{floor:.3e}), updated params max abs err {upd_err:.3e}; peak "
          f"device memory {peak:.2f} GB")
    del params, out, opt_state
    return dict(ms={f"{k} {p}": v for (k, p), v in ms.items()},
                calls={p: calls["mesh", p] for p in ("prefill", "step")},
                peak_gb=peak, err=max(max(errs), grad_err, upd_err),
                grad_floor=floor)


def phase_lm_mesh(card: str) -> dict:
    """The LM under a (1, 1) ("data", "model") mesh over NCCL at world size
    1 (one card holds one rank), through the registry's plans at full width
    and cut depth, each against the same plan without a mesh: qwen3-moe
    (sharded EP prefill, 2D EP decode), deepseek-v3 (2D EP prefill in
    chunks of 2048 tokens, 2D EP decode) and qwen2-0.5b (context-parallel
    prefill and a train step with seq_shard); attention through the flash
    attention kernel, no DLRM kernel."""
    import torch.distributed as dist
    reset_counts()
    t0 = time.perf_counter()
    pg_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dmesh.init("cuda", rank=0, world_size=1,
               store=dist.FileStore(os.path.join(pg_dir, "store"), 1))
    out: dict = {"archs": {}}
    try:
        mesh = dmesh.make_mesh((1, 1), ("data", "model"), "cuda")
        print(f"[lm_mesh] process group: {dist.get_backend()}, world size "
              f"{dist.get_world_size()}; mesh {mesh.shape} on {mesh.device}")
        for name, cut, b in LM_MESH_RUNS:
            out["archs"][name] = lm_mesh_serve(mesh, name, cut, b, card)
            gc.collect()
            torch.cuda.empty_cache()
        out["archs"][LM_MESH_TRAIN[0]] = lm_mesh_train(mesh, card)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)
    torch.cuda.synchronize()
    launches, routes = read_counts(), read_routes()
    print(f"[lm_mesh] the phase took {time.perf_counter() - t0:.1f} s")
    # each arch's mesh prefill through its layers, and qwen2's train step
    # forward and backward (two launches a layer), all bf16
    layers = [cut["n_layers"] for _, cut, _ in LM_MESH_RUNS]
    n_train = LM_MESH_TRAIN[1]["n_layers"]
    n_fwd = sum(layers) + 2 * n_train
    check_lm_launches("lm_mesh", launches, routes, fwd=n_fwd,
                      bwd=2 * n_train, wgmma_fwd=n_fwd,
                      wgmma_bwd=2 * n_train)
    out["launches"], out["routes"] = launches, routes
    return out


# ------------------------------------------------------------- lm_blocks --
# one rank's blocks of the 16 x 16 production mesh at full width and depth,
# on the card under the fake process group (its collectives move nothing:
# compute only, collectives not run)
LM_BLOCK_CELLS = (("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
                  ("qwen3-1.7b", "decode_32k"),
                  ("deepseek-v3-671b", "decode_32k"))
LM_BLOCK_REPS = {"train_4k": 1, "prefill_32k": 2, "decode_32k": 5}


def lm_rank_blocks(mesh, args, specs, vocab: int,
                   gen: torch.Generator) -> tuple:
    """Rank ``mesh.coord``'s block of each of a plan's ``args`` (meta
    tensors at full size) under ``specs``, on the card: weights N(0, 0.02)
    in their dtype, norms' gammas 1, token ids in the vocab, the optimizer
    state and step counts zero."""
    from repro_torch.distributed.shardings import block_index
    out = []
    for i, (arg, sp) in enumerate(zip(args, specs, strict=True)):
        leaves = []
        for (path, x), spec in zip(tree.flatten_with_path(arg),
                                   tree.flatten_up_to(arg, sp),
                                   strict=True):
            idx = block_index(mesh.shape, spec, tuple(x.shape), mesh.coord)
            shape = tuple(sl.stop - sl.start for sl in idx)
            if not x.is_floating_point():
                y = (torch.randint(0, vocab, shape, generator=gen,
                                   device="cuda", dtype=x.dtype)
                     if "['t']" not in path else
                     torch.zeros(shape, dtype=x.dtype, device="cuda"))
            elif i > 0:                          # optimizer state
                y = torch.zeros(shape, dtype=x.dtype, device="cuda")
            elif "gamma" in path:
                y = torch.ones(shape, dtype=x.dtype, device="cuda")
            else:
                y = torch.empty(shape, dtype=x.dtype, device="cuda").normal_(
                    0.0, 0.02, generator=gen)
            leaves.append(y)
        out.append(tree.unflatten(arg, leaves))
    return tuple(out)


def lm_cache_block(cfg, mesh) -> dict:
    """Rank ``mesh.coord``'s zero block of the decode cell's bf16 cache
    on the card, as ``models.lm.init_cache`` makes it under the mesh (its
    rows over ``data``, its slots over ``model``)."""
    import dataclasses

    from repro_torch.configs.lm_common import LM_SHAPES
    from repro_torch.models import lm
    shp = LM_SHAPES["decode_32k"]
    return lm.init_cache(dataclasses.replace(cfg, batch_axes=("data",)),
                         shp["batch"], shp["seq"], torch.bfloat16, "cuda",
                         mesh)


def phase_lm_blocks(card: str, dry: dict) -> dict:
    """Rank 0's blocks of the 16 x 16 production mesh on the card, at full
    width and depth, for qwen3-1.7b's three cells and deepseek-v3-671b's
    decode_32k: each plan's ``fn`` (its TP, FSDP and split-K code) on real
    CUDA tensors under the fake 256-rank process group
    (``distributed.mesh.init("meta")``), whose collectives move nothing.
    So only time and memory are read, compute only (collectives not run):
    the per-call time and the card's peak memory, beside the dry-run's
    counted peak for the same cell. The values are garbage where a gather
    moved nothing and are not held; the CPU tests hold them."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    reset_counts()
    t0 = time.perf_counter()
    counted = {(x["arch"], x["shape"]): x["roofline"]["memory"]["peak_bytes"]
               for x in dry["records"]
               if x["status"] == "ok" and x["mesh"] == "16x16"}
    dmesh.init("meta", rank=0, world_size=256)
    out: dict = {}
    try:
        mesh = make_production_mesh(multi_pod=False, device="meta")
        gen = torch.Generator(device="cuda").manual_seed(11)
        print(f"[lm_blocks] process group: {dist.get_backend()}, world size "
              f"{dist.get_world_size()}; mesh {mesh.shape}, rank 0 at "
              f"{mesh.coord}; CUDA tensors, compute only (collectives not "
              f"run)")
        for name, cell in LM_BLOCK_CELLS:
            bundle = configs.get_arch(name)
            plan = bundle.steps[cell].make_fn(bundle, mesh, False)
            if plan.layout is not None:
                raise AssertionError(f"{name} {cell}: layout is not None")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_gb = torch.cuda.memory_allocated() / 1e9
            if cell == "decode_32k":   # the cache's block by init_cache
                blocks = lm_rank_blocks(mesh, plan.args[::2],
                                        plan.local_specs()[::2],
                                        bundle.cfg.vocab, gen)
                blocks = (blocks[0], lm_cache_block(bundle.cfg, mesh),
                          blocks[1])
            else:
                blocks = lm_rank_blocks(mesh, plan.args, plan.local_specs(),
                                        bundle.cfg.vocab, gen)
            args_gb = torch.cuda.memory_allocated() / 1e9 - base_gb
            grad = torch.enable_grad() if cell == "train_4k" \
                else torch.inference_mode()
            with grad:
                plan.fn(*blocks)                    # the first call
                torch.cuda.synchronize()
                reps = LM_BLOCK_REPS[cell]
                t1 = time.perf_counter()
                for _ in range(reps):
                    res = plan.fn(*blocks)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3 / reps
            peak = torch.cuda.max_memory_allocated() / 1e9 - base_gb
            want = counted.get((name, cell), float("nan")) / 1e9
            # the output blocks: train's params, decode's cache as they
            # came in; the logits the rank's rows of its vocab block
            got, like = {"train_4k": (res[0], blocks[0]),
                         "decode_32k": (res[1], blocks[1]),
                         "prefill_32k": (res[0], None)}[cell]
            shapes = ([tuple(x.shape) for x in tree.leaves(like)]
                      if like is not None else
                      [(blocks[1].shape[0], bundle.cfg.vocab // 16)])
            if [tuple(x.shape) for x in tree.leaves(got)] != shapes:
                raise AssertionError(f"{name} {cell}: output blocks of "
                                     "other shapes than the plan's")
            out[f"{name} {cell}"] = dict(ms=ms, peak_gb=peak, args_gb=args_gb,
                                         dryrun_peak_gb=want)
            print(f"[lm_blocks] {name} {cell} at full width and depth, rank "
                  f"0 of 16 x 16 on {card}: {ms:.1f} ms per call (compute "
                  f"only, collectives not run); arguments {args_gb:.2f} GB, "
                  f"peak device memory {peak:.2f} GB (dry-run's counted peak "
                  f"{want:.2f} GB)")
            del blocks, res
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    launches, routes = read_counts(), read_routes()
    print(f"[lm_blocks] the phase took {time.perf_counter() - t0:.1f} s")
    # qwen3-1.7b's prefill_32k and train_4k calls (the first and the timed
    # ones) through every layer, bf16; decode attends without the kernel
    n = configs.LM_ARCHS["qwen3-1.7b"].n_layers
    calls = {c: 1 + LM_BLOCK_REPS[c] for c in ("prefill_32k", "train_4k")}
    n_fwd, n_bwd = n * sum(calls.values()), 2 * n * calls["train_4k"]
    check_lm_launches("lm_blocks", launches, routes, fwd=n_fwd, bwd=n_bwd,
                      wgmma_fwd=n_fwd, wgmma_bwd=n_bwd)
    out["launches"], out["routes"] = launches, routes
    return out


# ----------------------------------------------------------- recsys_mesh --
# DIN's and BERT4Rec's registry cells, their item tables row-sharded over
# "model": (a) on a (1, 1) NCCL mesh at the registry's widths against the
# same plans without a mesh, (b) rank 0's blocks of the 16 x 16 mesh under
# the fake group (compute only). Batches are the registry's but where one
# card cannot hold the whole batch:
RECSYS_MESH_ARCHS = ("din", "bert4rec")
RECSYS_MESH_CUTS = {
    # the whole batch's (262,144, 2, 200, 200) f32 attention logits alone
    # are 84 GB, and its scores 28 GB (the mesh path holds the block, its
    # transpose and the gathered scores at once); 16,384 rows are the 16 x
    # 16 mesh's rank's
    ("bert4rec", "serve_bulk"): 16_384,
}
RECSYS_MESH_REPS = {"train_batch": 2, "serve_p99": 10, "serve_bulk": 3,
                    "retrieval_cand": 3}


def recsys_inputs(args, specs, mesh, cfg, gen: torch.Generator) -> tuple:
    """Rank ``mesh.coord``'s block of each of a recsys plan's ``args``
    (meta tensors at full size) under ``specs`` (whole on a (1, 1) mesh),
    on the card: the params N(0, 0.02) and the layer norms' gammas 1, the
    optimizer state uniform in [0.5, 1.5] (a state far from AdamW's first
    step, whose sign(g) rounding noise flips) and its step counts zero;
    the batch's ids in the item range (``mask_pos`` in the sequence),
    masks true at 0.8, labels 0 or 1, features N(0, 1)."""
    from repro_torch.distributed.shardings import block_index
    out = []
    for i, (arg, sp) in enumerate(zip(args, specs, strict=True)):
        state, batch = i == 1 and len(args) == 3, i == len(args) - 1
        leaves = []
        for (path, x), spec in zip(tree.flatten_with_path(arg),
                                   tree.flatten_up_to(arg, sp),
                                   strict=True):
            idx = block_index(mesh.shape, spec, tuple(x.shape), mesh.coord)
            shape = tuple(sl.stop - sl.start for sl in idx)
            kw = dict(generator=gen, device="cuda")
            if x.dtype == torch.bool:
                y = torch.rand(shape, **kw) < 0.8
            elif not x.is_floating_point():
                hi = cfg.seq_len if "mask_pos" in path else cfg.n_items
                y = (torch.zeros(shape, dtype=x.dtype, device="cuda")
                     if state else
                     torch.randint(0, hi, shape, dtype=x.dtype, **kw))
            elif state:
                y = torch.rand(shape, **kw) + 0.5
            elif batch and "labels" in path:
                y = (torch.rand(shape, **kw) < 0.4).float()
            elif batch:
                y = torch.randn(shape, **kw)
            elif "gamma" in path:
                y = torch.ones(shape, dtype=x.dtype, device="cuda")
            else:
                y = torch.empty(shape, dtype=x.dtype, device="cuda").normal_(
                    0.0, 0.02, generator=gen)
            leaves.append(y)
        out.append(tree.unflatten(arg, leaves))
    return tuple(out)


def compare_trees(label: str, got, want, tol: dict) -> float:
    """Each float leaf of ``got`` against its counterpart in ``want`` at
    ``tol``, printed as one line; raises on a miss. Returns the max abs
    error."""
    worst = 0.0
    pairs = [(path, a, b) for (path, a), b in zip(
        tree.flatten_with_path(got), tree.leaves(want), strict=True)
        if a.is_floating_point()]
    for path, a, b in pairs:
        worst = max(worst, float((a.float() - b.float()).abs().max()))
        if not torch.allclose(a.float(), b.float(), **tol) \
                or not torch.isfinite(a).all():
            raise AssertionError(f"{label}: {path} differs beyond the "
                                 "tolerance")
    print(f"[check] {label}: {len(pairs)} tensors, max_abs_err {worst:.3e} "
          f"(rtol {tol['rtol']}, atol {tol['atol']}) ok")
    return worst


def recsys_mesh_cells(mesh, name: str, card: str, gen: torch.Generator
                      ) -> dict:
    """``name``'s four registry cells under the (1, 1) ``mesh`` against
    the same plans without one, with the model's init params at full
    width: each serve cell's output, the train cell's loss, gradients
    (``plan.grads``) and the params and optimizer state after one step;
    the mesh and mesh-free times, the collectives per call and the peak
    memory."""
    from unittest import mock
    out: dict = {}
    bundle = configs.get_arch(name)
    params = bundle.init(0, device="cuda")
    for cell, step in bundle.steps.items():
        full = configs.RECSYS_SHAPES[cell]
        cut = RECSYS_MESH_CUTS.get((name, cell))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.dict(configs.RECSYS_SHAPES,
                             {cell: {**full, "batch": cut or full["batch"]}}):
            plans = {k: step.make_fn(bundle, m, False)
                     for k, m in (("mesh", mesh), ("mesh-free", None))}
        free = plans["mesh-free"]
        inputs = recsys_inputs(free.args, free.local_specs(), mesh,
                               bundle.cfg, gen)
        batch = inputs[-1]
        rows = (f"{full['n_candidates']} candidates"
                if "n_candidates" in full else
                f"{cut} rows (cut from {full['batch']})" if cut
                else f"{full['batch']} rows")
        label = f"recsys_mesh {name} {cell} ({rows}), f32 on {card}"
        ms, calls, errs = {}, {}, []
        if step.kind == "serve":
            with torch.inference_mode():
                res = {}
                for k, plan in plans.items():
                    res[k], calls[k] = _calls(mesh, lambda plan=plan: plan.fn(
                        params, batch))
                    ms[k] = call_ms(lambda plan=plan: plan.fn(params, batch),
                                    reps=RECSYS_MESH_REPS[cell])
            errs.append(compare(f"{label}: output, mesh vs mesh-free",
                                res["mesh"], res["mesh-free"], RECSYS_TOL))
        else:
            state = inputs[1]
            res = {}
            for k, plan in plans.items():
                res[k, "grads"], calls[k] = _calls(
                    mesh, lambda plan=plan: plan.grads(params, batch))
                res[k, "step"] = plan.fn(params, state, batch)
                ms[k] = call_ms(lambda plan=plan: plan.fn(params, state,
                                                          batch),
                                reps=RECSYS_MESH_REPS[cell])
            errs.append(compare(f"{label}: loss, mesh vs mesh-free",
                                res["mesh", "grads"][0],
                                res["mesh-free", "grads"][0], RECSYS_TOL))
            # a bias before a softmax over the positions it shifts has an
            # exactly zero gradient, rounding noise on either side: held
            # joined to its layer's weight (phase_recsys)
            cfg = bundle.cfg
            biases = ((f"['attn'][{len(cfg.attn_mlp)}]['b']",)
                      if name == "din" else
                      tuple(f"['blocks'][{i}]['wk']['b']"
                            for i in range(cfg.n_blocks)))
            grads = [_join_softmax_biases(params, tree.leaves(
                res[k, "grads"][1]), biases) for k in ("mesh", "mesh-free")]
            items = tuple(res["mesh", "grads"][1]["items"].shape)
            check_tensors(f"{label}: every gradient block (items {items}), "
                          f"mesh vs mesh-free", *grads, RECSYS_GRAD_REL_L2)
            grad_err = max(float((a - b).abs().max())
                           for a, b in zip(*grads, strict=True))
            # the floor: the mesh-free gradients against a second run of
            # themselves (index_add_'s atomics sum the item rows in any
            # order)
            floor = max(float((a - b).abs().max()) for a, b in zip(
                _join_softmax_biases(params, tree.leaves(
                    free.grads(params, batch)[1]), biases), grads[1],
                strict=True))
            errs.append(grad_err)
            for j, part in enumerate(("params", "optimizer state")):
                errs.append(compare_trees(
                    f"{label}: {part} after one step, mesh vs mesh-free",
                    res["mesh", "step"][j], res["mesh-free", "step"][j],
                    RECSYS_TOL))
            print(f"[recsys_mesh] {name} {cell}: gradients max abs err "
                  f"{grad_err:.3e} (mesh-free against a second mesh-free "
                  f"run: {floor:.3e})")
            out[f"{cell} grad_floor"] = floor
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"[recsys_mesh] {name} {cell} at full width on {card}: {rows}; "
              f"mesh / mesh-free {ms['mesh']:.3f} / {ms['mesh-free']:.3f} ms "
              f"per call; collectives per call {calls['mesh']}; peak device "
              f"memory {peak:.2f} GB; max abs err {max(errs):.3e}")
        out[cell] = dict(ms=ms["mesh"], free_ms=ms["mesh-free"],
                         calls=calls["mesh"], peak_gb=peak, err=max(errs),
                         rows=rows)
        del plans, inputs, batch, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def recsys_mesh_blocks(card: str, dry: dict, gen: torch.Generator) -> dict:
    """Rank 0's blocks of the 16 x 16 production mesh for every cell of
    DIN and BERT4Rec at the registry's shapes, as CUDA tensors under the
    fake 256-rank group (its collectives move nothing, so compute only and
    the values not held): the per-call time and peak memory beside the
    dry-run's counted peak."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    counted = {(x["arch"], x["shape"]): x["roofline"]["memory"]["peak_bytes"]
               for x in dry["records"]
               if x["status"] == "ok" and x["mesh"] == "16x16"}
    dmesh.init("meta", rank=0, world_size=256)
    out: dict = {}
    try:
        mesh = make_production_mesh(multi_pod=False, device="meta")
        for name in RECSYS_MESH_ARCHS:
            bundle = configs.get_arch(name)
            for cell, step in bundle.steps.items():
                plan = step.make_fn(bundle, mesh, False)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base_gb = torch.cuda.memory_allocated() / 1e9
                blocks = recsys_inputs(plan.args, plan.local_specs(), mesh,
                                       bundle.cfg, gen)
                if tuple(blocks[0]["items"].shape) != (
                        bundle.cfg.n_items // 16, bundle.cfg.embed_dim):
                    raise AssertionError(f"{name} {cell}: rank 0 holds "
                                         "another block of items")
                grad = torch.enable_grad() if step.kind == "train" \
                    else torch.inference_mode()
                with grad:
                    plan.fn(*blocks)                    # the first call
                    torch.cuda.synchronize()
                    reps = RECSYS_MESH_REPS[cell]
                    t1 = time.perf_counter()
                    for _ in range(reps):
                        plan.fn(*blocks)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t1) * 1e3 / reps
                peak = torch.cuda.max_memory_allocated() / 1e9 - base_gb
                want = counted.get((name, cell), float("nan")) / 1e9
                out[f"{name} {cell}"] = dict(ms=ms, peak_gb=peak,
                                             dryrun_peak_gb=want)
                print(f"[recsys_mesh] {name} {cell}, rank 0 of 16 x 16 on "
                      f"{card}: {ms:.3f} ms per call (compute only, "
                      f"collectives not run); peak device memory "
                      f"{peak:.2f} GB (dry-run's counted peak {want:.2f} "
                      f"GB)")
                del blocks
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def phase_recsys_mesh(card: str, dry: dict) -> dict:
    """DIN's and BERT4Rec's registry cells with the item tables row-sharded
    over ``model``: every cell on a (1, 1) ("data", "model") NCCL mesh at
    world size 1 against the same plan without a mesh (the masked lookup,
    the sharded logsumexp and the score gather run at one rank, where they
    do the mesh-free arithmetic, so the values are held), then rank 0's
    blocks of the 16 x 16 mesh under the fake group; no launch of any
    kernel."""
    import torch.distributed as dist
    reset_counts()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(13)
    pg_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dmesh.init("cuda", rank=0, world_size=1,
               store=dist.FileStore(os.path.join(pg_dir, "store"), 1))
    out: dict = {"cells": {}}
    try:
        mesh = dmesh.make_mesh((1, 1), ("data", "model"), "cuda")
        print(f"[recsys_mesh] process group: {dist.get_backend()}, world "
              f"size {dist.get_world_size()}; mesh {mesh.shape} on "
              f"{mesh.device}")
        for name in RECSYS_MESH_ARCHS:
            out["cells"][name] = recsys_mesh_cells(mesh, name, card, gen)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)
    out["blocks"] = recsys_mesh_blocks(card, dry, gen)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"[recsys_mesh] launches of the port's kernels over the phase: "
          f"{launches}; the phase took {time.perf_counter() - t0:.1f} s")
    if any(launches.values()):
        raise AssertionError("DIN's or BERT4Rec's mesh path launched a DLRM "
                             "kernel")
    out["launches"] = launches
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # each phase's seconds (its name marks its end)
    marks: list[tuple[str, float]] = [("start", t_start)]

    def mark(name: str) -> None:
        marks.append((name, time.perf_counter()))

    build = phase_build()
    err = phase_check(gen)
    mark("build and check")
    res, launches = phase_serve()
    mark("serve")
    retrieval = phase_retrieval(res)
    mark("retrieval")
    records = phase_time(res, launches, err)
    mark("time")
    phase_profile(res)
    mark("profile")
    check_report(res)
    bf16 = phase_bf16(res, card)
    mark("bf16")
    served = {k: v.clone() for k, v in res.inputs[0].items()}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train()
    mark("train")
    phase_resume()
    phase_cli()
    mark("resume and cli")
    gc.collect()
    torch.cuda.empty_cache()
    sharded = phase_sharded(served, card)
    mark("sharded")
    gc.collect()
    torch.cuda.empty_cache()
    recsys = phase_recsys(card)
    mark("recsys")
    gc.collect()
    torch.cuda.empty_cache()
    registry = phase_registry(card)
    mark("registry")
    gc.collect()
    torch.cuda.empty_cache()
    dcn = phase_dcn(card, gen)
    mark("dcn")
    gc.collect()
    torch.cuda.empty_cache()
    phase_sls_probe(card)
    mark("sls_probe")
    gc.collect()
    torch.cuda.empty_cache()
    lm_out = phase_lm(card)
    mark("lm")
    gc.collect()
    torch.cuda.empty_cache()
    lm_mesh = phase_lm_mesh(card)
    mark("lm_mesh")
    gc.collect()
    torch.cuda.empty_cache()
    dryrun = phase_dryrun()
    mark("dryrun")
    recsys_mesh = phase_recsys_mesh(card, dryrun)
    mark("recsys_mesh")
    gc.collect()
    torch.cuda.empty_cache()
    lm_blocks = phase_lm_blocks(card, dryrun)
    mark("lm_blocks")
    records.append(attention_record(
        lm_out["attention"], err, lm_out["launches"],
        {"lm": lm_out["routes"], "lm_mesh": lm_mesh["routes"],
         "lm_blocks": lm_blocks["routes"]}, build))
    by_path = {"serve": launches, "train": train["launches"],
               "retrieval": retrieval["launches"],
               "sharded": sharded["launches"], "bf16": bf16["launches"],
               "recsys": recsys["launches"], "lm": lm_out["launches"],
               "lm_mesh": lm_mesh["launches"],
               "recsys_mesh": recsys_mesh["launches"],
               "lm_blocks": lm_blocks["launches"],
               "registry": registry["launches"], "dcn": dcn["launches"]}
    for r in records:
        for e in [r, *r["entries"]]:
            name = e["entry"] if e["entry"] in COUNTERS else e["name"]
            e["launches_by_path"] = {k: v[name] for k, v in by_path.items()}
            e["launches"] = sum(e["launches_by_path"].values())
            if name in bf16["kernels"]:
                e["bf16"] = bf16["kernels"][name]
            # the registry archs' serve inputs: new shapes of the kernel
            if e is r and all(name in a["kernels"]
                              for a in registry["archs"].values()):
                e["registry"] = {
                    arch: a["kernels"][name]
                    for arch, a in registry["archs"].items()}
    for r in records:
        for e in [r, *r["entries"]]:
            yard = (f"library {e['library_ms'] * 1e3:.2f} us"
                    if e["library_ms"] is not None else
                    f"yardstick {e['yardstick_ms'] * 1e3:.2f} us")
            print(f"[time] {e['name']} ({e['entry']}): {e['ms'] * 1e3:.2f} "
                  f"us/launch, launches {e['launches_by_path']} (plain "
                  f"{e['plain_ms'] * 1e3:.2f} us, {yard}, bound "
                  f"{e['bound_ms'] * 1e3:.3f} us by {e['bound_by']}) on "
                  f"{card}")
    print(f"[train] on {card}: warm step {train['step_ms']:.1f} ms ("
          + ", ".join(f"{k} {v:.2f} ms" for k, v in train["parts_ms"].items())
          + f"), peak {train['peak_gib']:.2f} GiB, checkpoint "
          f"{train['ckpt_gb']:.3f} GB in {train['ckpt_s']:.2f} s; retrieval "
          f"{retrieval['ms']:.3f} ms per 1 x {N_CANDIDATES} call")
    print(f"[sharded] on {card}: mesh forward, warm, batch 64: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in sharded["fwd_ms"].items())
          + "; training forward + backward at batch 4096: "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sharded["step_ms"].items()))
    print(f"[bf16] on {card}: serve step {bf16['serve_ms']:.3f} ms per "
          f"batch of 64, retrieval {bf16['retrieval_ms']:.3f} ms, training "
          f"step {bf16['step_ms']:.1f} ms at batch {TRAIN['batch']}; logits "
          f"vs plain {bf16['logit_err']:.3e}, gradients "
          f"{bf16['grad_err']:.3e} relative")
    print(f"[recsys] on {card}: "
          + "; ".join(f"{k} {v['ms']:.3f} ms" for k, v in
                      recsys["results"].items() if "ms" in v))
    for name, r in lm_out["archs"].items():
        print(f"[lm] {name} on {card}: batch {r['batch']}, prefill "
              f"{r['prefill_ms']:.1f} ms (bound {r['prefill_bound_ms']:.1f}), "
              f"{r['prefill_tok_s']:.0f} tokens/s; decode "
              f"{r['decode_ms']:.2f} ms/step (bound "
              f"{r['decode_bound_ms']:.2f}), {r['decode_tok_s']:.0f} "
              f"tokens/s; peak {r['peak_gb']:.2f} GB (least "
              f"{r['least_gb']:.2f}); decode vs full: "
              f"float32 max abs {r['err']:.3e}, bf16 drift "
              f"{r['bf16_drift'][1]:.3e} relative L2")
    att = lm_out["attention"]
    lay = lm_out["layers"]
    print(f"[lm] layers on {card}: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in lay["ms"].items())
          + "; bounds " + ", ".join(f"{k} {v:.3f} ms"
                                    for k, v in lay["bound_ms"].items()))
    tr = lm_out["train"]
    print(f"[lm] lm-100m on {card}: batch {tr['batch']}, seq 256: "
          f"{tr['step_ms']:.1f} ms per warm step, peak {tr['peak_gb']:.2f} GB")
    for dt in ("bf16", "f32", "mla", "f32_lm100m"):
        a = att[dt]
        print(f"[lm] flash attention {dt} on {card}: "
              + "; ".join(f"{p} {a['ms'][p]:.3f} ms (plain "
                          f"{a['plain_ms'][p]:.3f}, bound "
                          f"{a['bound_ms'][p]:.3f})"
                          for p in ("fwd", "bwd", "both")))
    for name, r in lm_mesh["archs"].items():
        print(f"[lm_mesh] {name} on {card}: mesh / mesh-free "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in r["ms"].items())
              + f"; collectives {r['calls']}; peak {r['peak_gb']:.2f} GB; "
              f"max abs err {r['err']:.3e}")
    for name, a in registry["archs"].items():
        print(f"[registry] {name} on {card}: "
              + ", ".join(f"{c} {v['ms']:.3f} ms (plain {v['plain_ms']:.3f})"
                          for c, v in a["cells"].items())
              + (f", train_batch {a['train']['ms']:.1f} ms"
                 if "train" in a else "")
              + f"; peak {a['peak_gb']:.2f} GB")
    for name, cells in recsys_mesh["cells"].items():
        print(f"[recsys_mesh] {name} on a (1, 1) mesh on {card}: mesh / "
              f"mesh-free " + ", ".join(
                  f"{c} {v['ms']:.3f} / {v['free_ms']:.3f} ms"
                  for c, v in cells.items() if isinstance(v, dict))
              + "; max abs err " + ", ".join(
                  f"{c} {v['err']:.3e}" for c, v in cells.items()
                  if isinstance(v, dict)))
    for key, r in recsys_mesh["blocks"].items():
        print(f"[recsys_mesh] {key}, rank 0 of 16 x 16 on {card}: "
              f"{r['ms']:.3f} ms per call (compute only, collectives not "
              f"run), peak {r['peak_gb']:.2f} GB (dry-run "
              f"{r['dryrun_peak_gb']:.2f} GB)")
    for key, r in lm_blocks.items():
        if key not in ("launches", "routes"):
            print(f"[lm_blocks] {key}, rank 0 of 16 x 16 on {card}: "
                  f"{r['ms']:.1f} ms per call (compute only, collectives "
                  f"not run), peak {r['peak_gb']:.2f} GB (dry-run "
                  f"{r['dryrun_peak_gb']:.2f} GB)")
    print(f"[dryrun] {dryrun['counts']['ok']} ok / "
          f"{dryrun['counts']['skip']} skip / {dryrun['counts']['error']} "
          f"fail")
    print("[time] phases: " + ", ".join(
        f"{name} {t - t_prev:.1f} s"
        for (_, t_prev), (name, t) in zip(marks, marks[1:])))
    print(f"[time] the whole run took {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
