"""hot_hit_share: the share of the window's lookups whose stored rank is
below its table's hot size, counted from the pool's ids, how often the
window used each pool entry, and the program's ``rank_of``."""

import numpy as np
import torch


def read(run):
    params, uses = run.params, run.pool_uses
    if uses is None or "rank_of" not in params or not uses.sum():
        return None
    idx = run.pool_indices                  # (N, B, n_tables, L)
    w = torch.as_tensor(uses, device=idx.device, dtype=torch.float64)
    hits = 0.0
    for t, (rank_of, hot) in enumerate(zip(params["rank_of"],
                                           params["hot_sizes"], strict=True)):
        ranks = rank_of[idx[:, :, t, :].long()]
        per_entry = (ranks < hot).sum(dim=(1, 2)).double()
        hits += float((per_entry * w).sum())
    lookups = float(np.sum(uses)) * idx[0].numel()
    return 100.0 * hits / lookups
