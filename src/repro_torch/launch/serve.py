"""Serving driver: the RecFlash inference service, storage lanes on the host
and the DLRM forward on the card.

Requests (one DLRM inference each) arrive on a Poisson or bursty open-loop
stream, wait in the ``RequestQueue``, are coalesced by the ``DynamicBatcher``
(max-batch / max-wait) and replayed through one ``Deployment``: one policy
lane per NAND access policy, each lane ``--channels`` concurrent SLS
servers, so the identical stream is replayed against RecSSD / RM-SSD /
RecFlash and per-request p50/p95/p99 latency and throughput come out per
policy. Those latencies are simulated flashsim time, not card time. The
card then scores the RecFlash lane's own batches through the DLRM forward
and the port's two kernels (tables stored frequency-remapped, logical ids
translated through ``rank_of`` inside the grouped SLS), padded to
``--batch`` rows (row 0 replicated) so every step has one shape.

The report lines are those of the reference's ``repro.launch.serve`` for
the same flags. ``--skip-compute`` runs the storage half alone and needs no
card; otherwise ``--device cuda`` (the default) raises without one.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 200 \\
        --skip-compute
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm_rm2 \\
        --requests 512 --rate 64000
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import DLRMConfig
from repro_torch.device import resolve_device
from repro_torch.embedding.layout import RemapSpec, remap_table
from repro_torch.models import dlrm
from repro_torch.serving import (Batch, BatcherConfig, Deployment,
                                 DeploymentConfig, LaneTrace,
                                 arch_model_config)

CPU_TABLE_GIB_LIMIT = 2.0       # host-memory guard, CPU runs only


@dataclasses.dataclass
class ServeResult:
    """What one serving run produced."""

    cfg: DLRMConfig
    dep_cfg: DeploymentConfig
    arrival: str
    rate: float
    traces: dict[str, LaneTrace]      # every policy lane's replay
    t_setup: float = 0.0              # host seconds: Deployment + stream
    t_sim: float = 0.0                # host seconds: replay of every lane
    params: dict | None = None        # remapped params (None: compute skipped)
    inputs: list[dict] = dataclasses.field(default_factory=list)
    logits: list[torch.Tensor] = dataclasses.field(default_factory=list)
    t_model: float = 0.0              # seconds building params on the device
    t_compute: float = 0.0            # seconds in forward steps, synchronised
    n_scored: int = 0

    @property
    def batches(self) -> list[Batch]:
        """The batches the card scores: the recflash lane's."""
        return self.traces["recflash"].batches


def batch_inputs(batch: Batch, cfg: DLRMConfig, dense_all: np.ndarray,
                 max_batch: int, device: torch.device) -> dict:
    """One batch's model inputs, padded to ``max_batch`` rows with row 0."""
    rids = np.array([r.rid for r in batch.requests])
    idx = np.stack([r.rows.reshape(cfg.n_tables, cfg.lookups)
                    for r in batch.requests])
    dense = dense_all[rids]
    pad = max_batch - idx.shape[0]
    if pad:
        idx = np.concatenate([idx, np.repeat(idx[:1], pad, axis=0)])
        dense = np.concatenate([dense, np.repeat(dense[:1], pad, axis=0)])
    return {"dense": torch.as_tensor(dense, dtype=torch.float32,
                                     device=device),
            "indices": torch.as_tensor(idx.astype(np.int32), device=device)}


def build_model(cfg: DLRMConfig, specs: list[RemapSpec], seed: int,
                device: torch.device) -> dict:
    """Parameters on ``device`` with every table stored in rank order.

    Tables are remapped one at a time and each logical copy is dropped as
    soon as its stored copy exists, so the peak is the tables plus one.
    """
    params = dlrm.init(seed, cfg, device=device)
    tables = params["tables"]
    for t, spec in enumerate(specs):
        tables[t] = remap_table(tables[t], spec)
    return dlrm.add_remap(params, [s.rank_of for s in specs],
                          [s.hot_size for s in specs])


def score_batches(inputs: list[dict], params: dict, cfg: DLRMConfig
                  ) -> tuple[list[torch.Tensor], float]:
    """Forward every padded batch; returns per-batch logits and the
    seconds spent in the steps (each ends in a device synchronise)."""
    on_card = params["tables"][0].device.type == "cuda"
    logits, t_compute = [], 0.0
    for batch in inputs:
        t0 = time.perf_counter()
        out = dlrm.forward(params, batch, cfg)
        if on_card:
            torch.cuda.synchronize()
        t_compute += time.perf_counter() - t0
        logits.append(out)
    return logits, t_compute


def serve(arch: str = "dlrm_small", requests: int = 50,
          rows: int | None = None, batch: int = 64,
          max_wait_us: float = 1000.0, rate: float = 200.0,
          arrival: str = "poisson", part: str = "TLC", channels: int = 1,
          k: float = 0.0, seed: int = 0, skip_compute: bool = False,
          device: str | torch.device = "cuda") -> ServeResult:
    """Build the deployment, replay the stream through every policy lane,
    then score the recflash lane's batches on ``device``."""
    dev = None if skip_compute else resolve_device(device)
    dep_cfg = DeploymentConfig.from_arch(
        arch, part=part, n_rows=rows, k=k, seed=seed, n_channels=channels,
        batcher=BatcherConfig(max_batch=batch, max_wait_us=max_wait_us))
    t0 = time.perf_counter()
    dep = Deployment(dep_cfg)
    reqs = dep.stream(requests, rate, arrival=arrival)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    traces = dep.run_stream(reqs)
    result = ServeResult(cfg=arch_model_config(dep_cfg), dep_cfg=dep_cfg,
                         arrival=arrival, rate=rate, traces=traces,
                         t_setup=t_setup, t_sim=time.perf_counter() - t0)
    if dev is None:
        return result
    cfg = result.cfg
    table_gib = sum(t.n_rows * t.vec_bytes for t in dep_cfg.tables) / 2**30
    if dev.type == "cpu" and table_gib > CPU_TABLE_GIB_LIMIT:
        print(f"[serve] compute skipped on the CPU: {arch} tables are "
              f"~{table_gib:.1f} GiB; pass --rows to scale them down or run "
              f"on the card")
        return result
    t0 = time.perf_counter()
    result.params = build_model(
        cfg, [RemapSpec.from_counts(s.counts) for s in dep.stats], seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    result.t_model = time.perf_counter() - t0
    dense_all = np.random.default_rng(seed * 7919).normal(
        size=(requests, cfg.n_dense)).astype(np.float32)
    result.inputs = [batch_inputs(b, cfg, dense_all, batch, dev)
                     for b in result.batches]
    padded, result.t_compute = score_batches(result.inputs, result.params,
                                             cfg)
    result.logits = [out[:b.size] for out, b in zip(padded, result.batches,
                                                    strict=True)]
    result.n_scored = sum(b.size for b in result.batches)
    return result


def report_lines(res: ServeResult) -> list[str]:
    """The reference serve's report: a header, one row per policy lane
    (simulated flashsim latency and throughput) and recflash against
    rmssd."""
    c = res.dep_cfg
    lines = [f"\n{res.arrival} arrivals @ {res.rate:.0f} req/s, "
             f"batcher <= {c.batcher.max_batch} reqs / "
             f"{c.batcher.max_wait_us:.0f} us wait, {c.part} part, "
             f"{c.n_channels} channel(s)/lane  "
             f"(simulated in {res.t_sim:.2f}s wall):\n"]
    lines += ["  " + tr.report.row() for tr in res.traces.values()]
    r_flash = res.traces["recflash"].report
    r_rmssd = res.traces["rmssd"].report
    if r_rmssd.p99_us > 0:
        lines.append(
            f"\nrecflash vs rmssd: "
            f"{1 - r_flash.p99_us / r_rmssd.p99_us:.1%} lower p99, "
            f"{r_flash.throughput_rps / max(r_rmssd.throughput_rps, 1e-9):.2f}x "
            f"throughput")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=50,
                    help="number of inference requests in the stream")
    ap.add_argument("--arch", default="dlrm_small",
                    help="registry arch for shapes (dlrm_small, dlrm_rm2, "
                         "dlrm_mlperf, rmc1/2/3)")
    ap.add_argument("--rows", type=int, default=None,
                    help="override rows per table")
    ap.add_argument("--batch", type=int, default=64,
                    help="dynamic batcher max batch size (requests)")
    ap.add_argument("--max-wait-us", type=float, default=1000.0,
                    help="batcher max-wait budget for the oldest request")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="mean arrival rate, requests/sec (simulated)")
    ap.add_argument("--arrival", choices=("poisson", "bursty"),
                    default="poisson")
    ap.add_argument("--part", choices=("SLC", "TLC", "QLC"), default="TLC")
    ap.add_argument("--channels", type=int, default=1,
                    help="concurrent SLS servers per policy lane")
    ap.add_argument("--k", type=float, default=0.0,
                    help="trace locality knob (0 = most local)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-compute", action="store_true",
                    help="storage-side simulation only (no forward, no card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = serve(arch=args.arch, requests=args.requests, rows=args.rows,
                batch=args.batch, max_wait_us=args.max_wait_us,
                rate=args.rate, arrival=args.arrival, part=args.part,
                channels=args.channels, k=args.k, seed=args.seed,
                skip_compute=args.skip_compute, device=args.device)
    cfg = res.cfg
    print(f"[serve] {cfg.name}: {cfg.n_tables} tables x {cfg.n_rows[0]} rows "
          f"x {cfg.embed_dim}, {cfg.lookups} lookups/table; recflash lane: "
          f"{len(res.batches)} batches; host set-up {res.t_setup:.2f}s")
    if res.params is not None:
        print(f"scored {res.n_scored} requests in {res.t_compute:.2f}s "
              f"compute ({1e3 * res.t_compute / max(1, len(res.batches)):.2f}"
              f" ms/batch forward)")
    for line in report_lines(res):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
