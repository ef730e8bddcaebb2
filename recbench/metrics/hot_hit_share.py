"""hot_hit_share: the share of the window's lookups whose stored rank is
below its table's hot size, counted from each table's ids in the pool (as
the cell's model lays them out: ``Model.table_ids``), how often the window
used each pool entry, and the program's ``rank_of``."""

import numpy as np
import torch


def read(run):
    params, uses = run.params, run.pool_uses
    if uses is None or "rank_of" not in params or not uses.sum():
        return None
    tables = run.cell.model.table_ids(run.pool_indices)   # each (N, B, L)
    w = torch.as_tensor(uses, device=run.pool_indices.device,
                        dtype=torch.float64)
    hits = 0.0
    for ids, rank_of, hot in zip(tables, params["rank_of"],
                                 params["hot_sizes"], strict=True):
        ranks = rank_of[ids.long()]
        per_entry = (ranks < hot).flatten(1).sum(1).double()
        hits += float((per_entry * w).sum())
    lookups = float(np.sum(uses)) * sum(ids[0].numel() for ids in tables)
    return 100.0 * hits / lookups
