"""Serving entry point on the card: the DLRM inference path of RecFlash.

Requests (one DLRM inference each) arrive on a Poisson or bursty open-loop
stream, wait in the ``RequestQueue`` and are coalesced by the
``DynamicBatcher`` (max-batch / max-wait). The model's tables are stored in
rank order by a frequency remap built from a sampled offline sweep, and each
batch is scored by the DLRM forward through the port's two kernels: the
two-tier SLS per table and the Gram interaction. Batches are padded to
``--batch`` rows (row 0 replicated), so every step has one shape.

The stream, the offline sweep and the dense features are those of the
reference's ``repro.launch.serve`` for the same flags. The reference's NAND
storage replay (its per-policy report) is not ported yet: batches come
straight from the batcher.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm_rm2 \\
        --requests 512 --rate 64000
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import DLRMConfig, arch_model_config
from repro_torch.core.freq import AccessStats
from repro_torch.data.tracegen import generate_sls_batch
from repro_torch.device import resolve_device
from repro_torch.embedding.layout import RemapSpec, remap_table
from repro_torch.models import dlrm
from repro_torch.serving.batcher import Batch, BatcherConfig, DynamicBatcher
from repro_torch.serving.queueing import RequestQueue
from repro_torch.serving.workload import (ARRIVAL_PROCESSES, Request,
                                          make_requests)

CPU_TABLE_GIB_LIMIT = 2.0       # host-memory guard, CPU runs only
SAMPLE_INFERENCES = 512         # offline-phase sampled training sweep


@dataclasses.dataclass
class ServeResult:
    """What one serving run produced."""

    cfg: DLRMConfig
    batches: list[Batch]
    params: dict | None = None        # remapped params (None: compute skipped)
    inputs: list[dict] = dataclasses.field(default_factory=list)
    logits: list[torch.Tensor] = dataclasses.field(default_factory=list)
    t_compute: float = 0.0            # seconds in forward steps, synchronised
    n_scored: int = 0


def offline_specs(cfg: DLRMConfig, k: float = 0.0,
                  seed: int = 0) -> list[RemapSpec]:
    """Offline phase: a sampled sweep -> per-table access counts -> the
    frequency remap of each table (``Deployment``'s sweep, seed + 1)."""
    n_rows = cfg.n_rows[0]
    tb, rows = generate_sls_batch(cfg.n_tables, n_rows, cfg.lookups,
                                  SAMPLE_INFERENCES, k=k, seed=seed + 1)
    return [RemapSpec.from_counts(
        AccessStats.from_trace(rows[tb == t], n_rows).counts)
        for t in range(cfg.n_tables)]


def make_stream(cfg: DLRMConfig, n_requests: int, rate_rps: float,
                arrival: str = "poisson", k: float = 0.0,
                seed: int = 0) -> list[Request]:
    """The open-loop request stream of ``Deployment.stream`` for the same
    shapes and seed: arrivals from ``seed + 2``, accesses from ``seed``."""
    ts = ARRIVAL_PROCESSES[arrival](n_requests, rate_rps, seed=seed + 2)
    return make_requests(n_requests, cfg.n_tables, cfg.n_rows[0], cfg.lookups,
                         ts, k=k, seed=seed)


def form_batches(requests: list[Request], max_batch: int,
                 max_wait_us: float) -> list[Batch]:
    """Drain the stream through the queue and the dynamic batcher."""
    queue = RequestQueue(requests)
    batcher = DynamicBatcher(BatcherConfig(max_batch=max_batch,
                                           max_wait_us=max_wait_us))
    batches = []
    while (b := batcher.next_batch(queue)) is not None:
        batches.append(b)
    return batches


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
          arrival: str = "poisson", k: float = 0.0, seed: int = 0,
          device: str | torch.device = "cuda") -> ServeResult:
    """Build the stream and the batches, then score them on ``device``."""
    dev = resolve_device(device)
    cfg = arch_model_config(arch, n_rows=rows)
    reqs = make_stream(cfg, requests, rate, arrival=arrival, k=k, seed=seed)
    result = ServeResult(cfg=cfg, batches=form_batches(reqs, batch,
                                                       max_wait_us))
    table_gib = cfg.n_tables * cfg.n_rows[0] * cfg.embed_dim * 4 / 2**30
    if dev.type == "cpu" and table_gib > CPU_TABLE_GIB_LIMIT:
        print(f"[serve] compute skipped on the CPU: {arch} tables are "
              f"~{table_gib:.1f} GiB; pass --rows to scale them down or run "
              f"on the card")
        return result
    specs = offline_specs(cfg, k=k, seed=seed)
    result.params = build_model(cfg, specs, seed, dev)
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
    ap.add_argument("--k", type=float, default=0.0,
                    help="trace locality knob (0 = most local)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = serve(arch=args.arch, requests=args.requests, rows=args.rows,
                batch=args.batch, max_wait_us=args.max_wait_us,
                rate=args.rate, arrival=args.arrival, k=args.k,
                seed=args.seed, device=args.device)
    cfg, n_b = res.cfg, len(res.batches)
    print(f"[serve] {cfg.name}: {cfg.n_tables} tables x {cfg.n_rows[0]} rows "
          f"x {cfg.embed_dim}, {cfg.lookups} lookups/table; {args.requests} "
          f"{args.arrival} requests @ {args.rate:.0f} req/s -> {n_b} batches "
          f"(<= {args.batch} reqs / {args.max_wait_us:.0f} us wait)")
    if res.params is not None:
        print(f"scored {res.n_scored} requests in {res.t_compute:.2f}s "
              f"compute ({1e3 * res.t_compute / max(1, n_b):.2f} ms/batch "
              f"forward)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
