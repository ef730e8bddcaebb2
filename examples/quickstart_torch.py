"""Quickstart on the PyTorch/CUDA port: the RecFlash idea in 60 lines.

The counterpart of ``examples/quickstart.py``; it imports no JAX.

1. Generate a skewed embedding-access trace (the recommendation workload).
2. Build the frequency statistics from a sampled sweep (offline phase).
3. Compare NAND access policies: RecSSD / RM-SSD / RecFlash (AF+PD+P$).
4. Run the compute half: the same statistics drive the two-tier SLS kernel
   (hot prefix, cold rows gathered from device memory), here the port's
   hand-written CUDA kernel on the card.

Steps 1-3 are the storage half (numpy) and print what the reference
quickstart prints, line for line. Step 4 runs on the card by default
(``--device cuda`` raises without one); ``--device cpu`` runs the kernel's
plain PyTorch version.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.engine import TableSpec
from repro_torch.core.freq import AccessStats
from repro_torch.data.tracegen import generate_trace
from repro_torch.device import resolve_device
from repro_torch.embedding.layout import RemapSpec, lookup, remap_table
from repro_torch.kernels import ops
from repro_torch.serving import Deployment, DeploymentConfig

N_ROWS, DIM = 100_000, 32

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda",
                help="cuda (the default; raises without a card) or cpu")
device = resolve_device(ap.parse_args().device)

# 1. workload: Zipf-skewed lookups, high locality (K=0 -> 8% unique rate)
sample = generate_trace(N_ROWS, 20_000, k=0.0, seed=1)   # offline sample
trace = generate_trace(N_ROWS, 20_000, k=0.0, seed=2)    # serving traffic

# 2. offline phase: access counts -> frequency stats
stats = AccessStats.from_trace(sample, N_ROWS)
print(f"unique-access rate: {stats.unique_access_rate():.1%} "
      f"(top-1% rows absorb "
      f"{np.sort(stats.counts)[::-1][:N_ROWS // 100].sum() / stats.counts.sum():.0%} of traffic)")

# 3. storage half: one Deployment = one engine lane per policy
print(f"\nTLC NAND, {len(trace):,} lookups:")
dep = Deployment(DeploymentConfig(
    tables=[TableSpec(n_rows=N_ROWS, vec_bytes=DIM * 4)], part="TLC"),
    sample_stats=[stats])
tb = np.zeros_like(trace)
for policy in dep.cfg.policies:
    r = dep.engines[policy].serve(tb, trace)
    print(f"  {policy:10s} latency {r.latency_us / 1e3:9.1f} ms   "
          f"page reads {r.n_page_reads:6d}   "
          f"cache hits {r.n_cache_hits:6d}   "
          f"energy {r.energy_uj / 1e3:8.1f} mJ")

# 4. compute half: two-tier SLS kernel on the remapped table
spec = RemapSpec.from_counts(stats.counts, hot_frac=0.01)
gen = torch.Generator(device=device).manual_seed(0)
table = torch.randn(N_ROWS, DIM, generator=gen, device=device)
stored = remap_table(table, spec)
hot, cold = stored[:spec.hot_size], stored[spec.hot_size:]

bags = torch.from_numpy(trace[:4096].reshape(512, 8)).to(device)  # 512 x 8
rank_of = torch.from_numpy(spec.rank_of.astype(np.int32)).to(device)
ranks = lookup(rank_of, bags)
out = ops.recflash_sls(hot, cold, ranks)
ref = ops.sls_ref(hot, cold, ranks)
hot_frac_hits = float((ranks < spec.hot_size).float().mean())
route = ("hand-written CUDA" if device.type == "cuda"
         else "plain PyTorch (CPU)")
print(f"\nTwo-tier SLS, {route}: {tuple(out.shape)} bags, "
      f"{hot_frac_hits:.1%} of lookups served from the hot tier, "
      f"max |err| vs oracle = {float((out - ref).abs().max()):.2e}")
