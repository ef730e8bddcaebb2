"""Host-side neighbor sampler for GraphSAGE minibatch training.

A numpy copy of the reference's ``repro.data.sampler``: the same graph and
generator give the same blocks, array for array.

Produces fixed-fanout padded neighbor blocks from a CSR adjacency — the
device-side model then runs dense gathers + masked means (static shapes).
Sampling is with replacement when a node's degree is below the fanout
(GraphSAGE's convention); isolated nodes get a fully-masked row.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray     # (N+1,)
    indices: np.ndarray    # (E,)
    feats: np.ndarray      # (N, F)
    labels: np.ndarray     # (N,)

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @classmethod
    def from_edges(cls, n_nodes, src, dst, feats, labels):
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.add.at(indptr, dst + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(indptr=indptr, indices=src, feats=feats, labels=labels)

    @classmethod
    def random(cls, n_nodes, avg_degree, d_feat, n_classes, seed=0):
        rng = np.random.default_rng(seed)
        e = n_nodes * avg_degree
        src = rng.integers(0, n_nodes, e)
        dst = rng.integers(0, n_nodes, e)
        feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
        labels = rng.integers(0, n_classes, n_nodes)
        return cls.from_edges(n_nodes, src, dst, feats, labels)


def sample_blocks(graph: CSRGraph, seeds: np.ndarray, fanouts,
                  rng: np.random.Generator):
    """Sample fixed-fanout blocks, outermost layer first.

    Returns the dict consumed by ``graphsage.forward_sampled``:
    layer l (l = 0 innermost == first applied) gathers from the node set of
    depth l and writes the node set of depth l+1 (seeds at the end).
    """
    # walk outward from seeds: layers reversed (last fanout nearest seeds)
    node_sets = [np.asarray(seeds, dtype=np.int64)]
    nbr_per_layer = []
    for fanout in reversed(fanouts):
        dst = node_sets[-1]
        deg = graph.indptr[dst + 1] - graph.indptr[dst]
        safe = np.maximum(deg, 1)
        pick = rng.integers(0, safe[:, None],
                            size=(dst.size, fanout))  # with replacement
        pos = np.minimum(graph.indptr[dst][:, None] + pick,
                         graph.indices.size - 1)
        mask = np.broadcast_to((deg > 0)[:, None], (dst.size, fanout)).copy()
        nbrs = np.where(mask, graph.indices[pos], dst[:, None])
        nbr_per_layer.append((nbrs, mask))
        node_sets.append(np.unique(np.concatenate([dst, nbrs.ravel()])))
    # innermost node set provides input features; re-index every block
    # (node sets are sorted by construction -> searchsorted remap).
    blocks = {"feats": graph.feats[node_sets[-1]], "nbrs": [], "self_idx": [],
              "mask": [], "labels": graph.labels[seeds]}
    for depth in range(len(fanouts)):
        # layer `depth` (applied depth-th) maps node_sets[-1-depth] ->
        # node_sets[-2-depth]
        src_set = node_sets[-1 - depth]
        dst_set = node_sets[-2 - depth]
        nbrs, mask = nbr_per_layer[-1 - depth]
        blocks["nbrs"].append(np.searchsorted(src_set, nbrs))
        blocks["self_idx"].append(np.searchsorted(src_set, dst_set))
        blocks["mask"].append(mask)
    return blocks
