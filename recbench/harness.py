"""One run of one cell: set-up, warm-up, the measured window, the traced
window, the metrics, the check.

Everything that belongs to the cell's model is its configuration's
``Model`` (``models/<module>.py``, found by the file's ``model`` key): the
port's config, the weights and the pool it makes from the seed, the
program it builds through the port, the timed forward and the plain
reference. For ``"dlrm"`` the timed path is the port's
``repro_torch.models.dlrm.forward`` under ``torch.inference_mode()``, on
parameters built by the port's own set-up path: each table's remap planned
from access counts of a separate sample of the traffic
(``embedding.layout.RemapSpec.from_counts``), the table stored in rank
order (``remap_table``) and the plans attached (``models.dlrm.add_remap``).
So the window runs the ``rank_of`` translation, the two-tier grouped SLS
kernel, the fused interaction kernel and the MLPs. The harness reads a
pool's ids only as a tensor whose leading dimensions are (entries,
samples).

Two drivers, chosen by the traffic's ``mode``:

- ``bulk``: a closed loop, batch after batch from a device-resident pool,
  the host enqueueing as fast as the card takes them; the window ends with
  a synchronise.
- ``online``: an open loop. Requests arrive on a seeded schedule in wall
  time; a batch leaves when it is full, when its oldest request has waited
  ``max_wait_us``, or, under backlog, as soon as the card is free (the
  port's ``serving.batcher`` rule in wall time). Each batch's rows are
  copied from a pool in pinned host memory inside the timed path and its
  logits back to the host; a request's latency runs from its scheduled
  arrival to its logits on the host.

``correct`` compares logits that the timed path produced, once the window
has closed and the program's state is freed, with the model's
``reference_logits``.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import random
import sys
import time

import numpy as np
import torch

from recbench import synth, traffic as traffic_mod
from recbench.devtrace import DeviceTrace
from recbench.spec import Benchmark, Cell

TRACE_SECONDS = 2.0      # the traced window, after the measured one
DRAIN_SECONDS = 60.0     # how long requests due in the window may take
CHECK_STEPS = 4          # bulk: steps whose logits are checked
CHECK_REQUESTS = 4096    # online: requests whose logits are checked
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"[recbench] {msg}", file=sys.stderr, flush=True)


def foreign_modules() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's,
    compared whole (so ``repro_torch`` is not one)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers (``metrics/*.py``)."""

    cell: Cell
    seed: int
    mode: str
    params: dict                    # the program's parameters (stored tables,
    pool_indices: torch.Tensor      # rank_of, hot sizes); the pool's ids
    setup_s: float = math.nan
    remap_s: float = math.nan
    window_s: float = math.nan
    samples: int = 0
    steps: int = 0
    pool_uses: np.ndarray | None = None
    latencies_ms: np.ndarray | None = None
    step_s: list = dataclasses.field(default_factory=list)
    trace: DeviceTrace | None = None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Reservoir:
    """A seeded uniform sample of ``k`` of a stream's items."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Bulk:
    """The closed loop over a device-resident pool of batches."""

    def __init__(self, run: Run, cfg, dense: torch.Tensor,
                 indices: torch.Tensor):
        self.forward = run.cell.model.forward(cfg, run.params)
        self.dense, self.indices = dense, indices
        self.next = 0
        self.keep = Reservoir(CHECK_STEPS, synth.derive(run.seed, "check"))

    def step(self, e: int) -> torch.Tensor:
        return self.forward(self.dense[e], self.indices[e])

    def warm_up(self) -> None:
        for e in range(min(3, self.dense.shape[0])):
            self.step(e)
        sync(self.dense.device)

    def drive(self, seconds: float, keep: bool):
        """Steps for ``seconds`` of enqueueing, then a synchronise.
        Returns (wall s, steps, uses per pool entry)."""
        n = self.dense.shape[0]
        uses = np.zeros(n, dtype=np.int64)
        steps = 0
        t0 = time.perf_counter()
        while True:
            e = self.next % n
            out = self.step(e)
            if keep:
                self.keep.offer((e, out))
            uses[e] += 1
            self.next += 1
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.dense.device)
        return time.perf_counter() - t0, steps, uses

    def checked(self):
        """(dense, indices, logits) of the checked steps."""
        for e, out in self.keep.items:
            yield self.dense[e], self.indices[e], out


class Online:
    """The open loop: a seeded arrival schedule, the batcher's rule in wall
    time, batches copied from pinned host memory."""

    def __init__(self, run: Run, cfg, traffic: dict, dense: torch.Tensor,
                 indices: torch.Tensor, seconds: float, device):
        self.forward = run.cell.model.forward(cfg, run.params)
        self.device = torch.device(device)
        self.max_batch = int(traffic["max_batch"])
        self.max_wait = float(traffic["max_wait_us"]) * 1e-6
        self.rate = float(traffic["rate_rps"])
        self.pool = dense.shape[0]
        mb = self.max_batch
        pin = self.device.type == "cuda"
        # rows [P, P + max_batch) repeat [0, max_batch): every batch is a
        # contiguous slice
        self.dense = torch.cat([dense[:, 0], dense[:mb, 0]]).cpu()
        self.indices = torch.cat([indices[:, 0], indices[:mb, 0]]).cpu()
        if pin:
            self.dense = self.dense.pin_memory()
            self.indices = self.indices.pin_memory()
        n = int(self.rate * (seconds + TRACE_SECONDS) * 1.2) + 4 * mb
        self.sched = traffic_mod.arrivals_s(traffic, n, run.seed)
        self.done = np.full(n, np.nan)
        self.logits = np.full(n, np.nan, dtype=np.float32)
        self.pos = 0

    def step(self, r0: int, r1: int) -> np.ndarray:
        s = r0 % self.pool
        n = r1 - r0
        out = self.forward(
            self.dense[s:s + n].to(self.device, non_blocking=True),
            self.indices[s:s + n].to(self.device, non_blocking=True))
        return out.float().cpu().numpy()

    def warm_up(self) -> None:
        """Every batch size the batcher can form, once."""
        for n in range(1, self.max_batch + 1):
            self.step(0, n)
        sync(self.device)

    def drive(self, t_end: float, offset: float, record: list | None):
        """Serve every request due before ``t_end`` on the schedule, whose
        time ``offset`` is now; return (wall s, batches, uses per pool
        entry, first request, end request due). ``record`` collects each
        batch's host seconds (forward and synchronise)."""
        sched, mb, mw = self.sched, self.max_batch, self.max_wait
        uses = np.zeros(self.pool, dtype=np.int64)
        first = self.pos
        due = int(np.searchsorted(sched, t_end, side="left"))
        if due > sched.size - mb:
            raise RuntimeError("the schedule is shorter than the window")
        clock = time.perf_counter
        t0 = clock() - offset
        steps = 0
        pos = first
        while pos < due:
            head = sched[pos]
            fill = sched[pos + mb - 1]
            now = clock() - t0
            dispatch = max(head, now, min(head + mw, fill))
            while clock() - t0 < dispatch:
                pass
            end = pos + int(np.searchsorted(sched[pos:pos + mb], dispatch,
                                            side="right"))
            ts = clock()
            out = self.step(pos, end)
            te = clock()
            self.done[pos:end] = te - t0
            if out.shape == (end - pos,):     # else they read NaN: wrong
                self.logits[pos:end] = out
            if record is not None:
                record.append(te - ts)
            idx = np.arange(pos, end) % self.pool
            np.add.at(uses, idx, 1)
            steps += 1
            pos = end
            if te - t0 > t_end + DRAIN_SECONDS:
                break
        self.pos = pos
        return clock() - t0 - offset, steps, uses, first, due

    def checked(self, first: int, due: int, seed: int):
        """(dense, indices, logits) of a seeded sample of the requests due
        in the window; a request that got no logits reads NaN."""
        n = due - first
        rng = np.random.default_rng(synth.derive(seed, "check"))
        pick = np.sort(rng.choice(n, size=min(n, CHECK_REQUESTS),
                                  replace=False)) + first
        e = torch.as_tensor(pick % self.pool)
        yield (self.dense[e].to(self.device), self.indices[e].to(self.device),
               torch.as_tensor(self.logits[pick]).to(self.device))


def traced_window(driver, run: Run, seconds: float) -> DeviceTrace:
    """``TRACE_SECONDS`` more of the cell's traffic under the profiler,
    after the measured window."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device(run.pool_indices.device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    sync(dev)
    prof.start()
    try:
        if run.mode == "bulk":
            wall, steps, uses = driver.drive(TRACE_SECONDS, False)
        else:
            wall, steps, uses, _, _ = driver.drive(
                seconds + TRACE_SECONDS, float(driver.sched[driver.pos]),
                None)
        sync(dev)
    finally:
        prof.stop()
    t = DeviceTrace.from_profiler(prof, wall, steps, uses)
    log(f"traced window: {wall:.3f} s, {steps} steps, {t.n_ops} device "
        f"operations, busy {t.busy_s:.6f} s")
    for name, s in t.top_ops(20):
        log(f"  device {1e3 * s / max(steps, 1):.4f} ms/step  {name}")
    return t


def logit_err(model, weights, seed, checked) -> float:
    """The largest gap between a checked logit and the reference's, over
    the root mean square of the reference's logits; inf where a logit is
    missing, not finite, or of the wrong shape."""
    worst, sq, count = 0.0, 0.0, 0
    for dense, indices, got in checked:
        want = model.reference_logits(weights, seed, dense, indices)
        if got.shape != want.shape:
            return math.inf
        gap = (got.float() - want).abs().max()
        if not torch.isfinite(gap):
            return math.inf
        worst = max(worst, float(gap))
        sq += float((want.double() ** 2).sum())
        count += want.numel()
    if count == 0:
        return math.inf
    return worst / max(math.sqrt(sq / count), 1e-30)


def prepare(cell: Cell, seed: int, dev: torch.device):
    """A run's set-up before its warm-up: the port's config, the harness's
    weights and pool, the program's parameters. Returns (cfg, weights,
    dense, indices, run)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = cell.model
    t0 = time.perf_counter()
    cfg = model.port_config()
    weights = model.make_weights(seed, dev)
    dense, indices, counts = model.make_pool(cell.traffic, seed, dev)
    sync(dev)
    t1 = time.perf_counter()
    params, remap_s = model.build_program(weights, counts, seed, dev)
    log(f"set-up: weights and pool {t1 - t0:.3f} s, tables and remap "
        f"{time.perf_counter() - t1:.3f} s (the port's calls {remap_s:.3f} "
        f"s)")
    run = Run(cell=cell, seed=seed, mode=cell.traffic["mode"], params=params,
              pool_indices=indices, remap_s=remap_s)
    return cfg, weights, dense, indices, run


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run of ``workload`` on ``device``: the result's JSON object,
    and its check lines on standard error."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Benchmark(root)
    cell = bench.cell(workload)
    model, tr = cell.model, cell.traffic
    dev = torch.device(device)
    log(f"set-up: {time.perf_counter() - t_start:.3f} s to the cell")
    cfg, weights, dense, indices, run = prepare(cell, seed, dev)
    params = run.params
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        if run.mode == "bulk":
            driver = Bulk(run, cfg, dense, indices)
        elif run.mode == "online":
            driver = Online(run, cfg, tr, dense, indices, seconds, dev)
            del dense
        else:
            raise ValueError(f"unknown traffic mode {run.mode!r}")
        t0 = time.perf_counter()
        driver.warm_up()
        gc.collect()
        run.setup_s = time.perf_counter() - t_start
        log(f"set-up: warm-up {run.setup_s - (t0 - t_start):.3f} s, "
            f"setup_s {run.setup_s:.3f}")
        if run.mode == "bulk":
            run.window_s, run.steps, run.pool_uses = driver.drive(seconds,
                                                                  True)
            b = dense.shape[1]
            run.samples = run.steps * b
            attempted, failed = run.samples, 0
        else:
            run.window_s, run.steps, run.pool_uses, first, due = \
                driver.drive(seconds, 0.0, run.step_s)
            lat = driver.done[first:due] - driver.sched[first:due]
            run.latencies_ms = lat * 1e3
            attempted = due - first
            failed = int(np.isnan(lat).sum())
            run.samples = attempted - failed
            late = max(0.0, float(np.nanmax(driver.done[first:due]))
                       - seconds)
            log(f"online: {attempted} requests due in {seconds} s at "
                f"{driver.rate} req/s, {run.steps} batches "
                f"({attempted / max(run.steps, 1):.1f} a batch, "
                f"{1e3 * float(np.mean(run.step_s)):.4f} ms a step), "
                f"drained {late:.4f} s after the window")
        if trace:
            run.trace = traced_window(driver, run, seconds)
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    metrics, missing = {}, []
    for m in bench.metrics(workload, trace):
        value = bench.reader(m["name"])(run)
        if value is None:
            missing.append(m["name"])
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if missing and not trace:
        raise RuntimeError(f"end-to-end metrics with nothing to read: "
                           f"{missing}")
    if missing:
        log(f"per-layer metrics with nothing to read: {missing}")
    # the check: the program's state freed first, the reference in blocks
    if run.mode == "bulk":
        checked = [(d, i, out.clone()) for d, i, out in driver.checked()]
    else:
        checked = list(driver.checked(first, due, seed))
    traced = run.trace
    del run, driver, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with torch.inference_mode():
        err = logit_err(model, weights, seed, checked)
    limit = model.logit_err_limit
    checks = {"logit_err": {"value": err, "limit": limit},
              "unanswered": {"value": failed, "limit": 0}}
    correct = bool(err <= limit and failed == 0)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if traced is not None:
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.top_ops(),
                               "idle_gaps": traced.idle_gaps()}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result
