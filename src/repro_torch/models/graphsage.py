"""GraphSAGE (arXiv:1706.02216), mean aggregator, 2 layers, d_hidden=128,
on torch tensors.

Three execution regimes, as in the reference (``repro.models.graphsage``):

* full graph (Cora-sized ``full_graph_sm``): message passing over the
  edge list, the reference's ``jax.ops.segment_sum`` as ``index_add``
  (atomic on the card, so its sums come in no fixed order);
* sampled minibatch (``minibatch_lg``, Reddit-scale): the host-side
  neighbour sampler (``repro_torch.data.sampler``) emits fixed-fanout
  padded neighbour blocks, so the device runs dense gathers and masked
  means;
* batched small graphs (``molecule``): the reference vmaps one graph's
  segment sums; here the B graphs' nodes are laid end to end and summed in
  one ``index_add`` over B x N nodes, each graph's edges offset to its own
  nodes, followed by a masked mean readout per graph.

Plain PyTorch, as the reference is plain ``jnp``. A node index out of range
is clamped (``embedding.layout.lookup``, within its own graph for the
batched regime); an edge whose destination is out of range adds nothing,
as ``segment_sum`` drops it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import psum
from repro_torch.embedding.layout import lookup
from repro_torch.models.common import (dense, dense_init, make_generator,
                                       mlp, mlp_init)


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602                  # Reddit features
    n_classes: int = 41
    fanouts: tuple = (25, 10)
    aggregator: str = "mean"
    readout: str | None = None       # "mean" -> graph-level classification


def init(seed: int, cfg: SAGEConfig, dtype=torch.float32,
         device: str | torch.device = "cuda") -> dict:
    """Random parameters with the reference's distributions, drawn on
    ``device`` from a generator seeded with ``seed`` (not JAX's draws)."""
    gen = make_generator(seed, resolve_device(device))
    layers = []
    d_prev = cfg.d_in
    for _ in range(cfg.n_layers):
        layers.append({
            "w_self": dense_init(gen, d_prev, cfg.d_hidden, dtype,
                                 bias=True),
            "w_neigh": dense_init(gen, d_prev, cfg.d_hidden, dtype),
        })
        d_prev = cfg.d_hidden
    return {"layers": layers,
            "cls": mlp_init(gen, (d_prev, cfg.n_classes), dtype)}


def _sage_layer(p, h_self: torch.Tensor, h_neigh: torch.Tensor,
                is_last: bool) -> torch.Tensor:
    out = dense(p["w_self"], h_self) + dense(p["w_neigh"], h_neigh)
    if not is_last:
        out = torch.relu(out)
        out = out / torch.clamp_min(
            torch.linalg.vector_norm(out, dim=-1, keepdim=True), 1e-6)
    return out


def _segment_sum(data: torch.Tensor, seg: torch.Tensor,
                 n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(data, seg, num_segments=n)``: rows of ``data``
    added into ``n`` segments; a segment id outside [0, n) adds nothing."""
    ok = (seg >= 0) & (seg < n)
    data = data * ok.reshape(-1, *([1] * (data.dim() - 1))).to(data.dtype)
    return data.new_zeros((n,) + data.shape[1:]).index_add(
        0, seg.clamp(0, n - 1), data)


def _log_softmax_nll(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, labels[:, None].long(), dim=-1)[:, 0]


def forward_full(params, x: torch.Tensor, edge_src: torch.Tensor,
                 edge_dst: torch.Tensor, cfg: SAGEConfig,
                 n_nodes: int | None = None, mesh=None,
                 axes=("data",)) -> torch.Tensor:
    """Full-graph forward. x (N,F); edges src->dst (E,) each -> (N,
    n_classes) logits.

    Under a mesh the edges are this rank's block over ``axes`` (the
    nodes whole on every rank): each segment sum, the degrees' too, is
    summed over ``axes``, so every rank computes the whole graph's logits.
    """
    n = n_nodes or x.shape[0]

    def agg(data):
        out = _segment_sum(data, edge_dst, n)
        return out if mesh is None else psum(out, mesh, axes)

    deg = agg(torch.ones(edge_dst.shape, dtype=torch.float32,
                         device=edge_dst.device))
    deg = torch.clamp_min(deg, 1.0)[:, None]
    h = x
    for i, p in enumerate(params["layers"]):
        neigh = agg(lookup(h, edge_src)) / deg
        h = _sage_layer(p, h, neigh, is_last=(i == cfg.n_layers - 1))
    return mlp(params["cls"], h)


def forward_sampled(params, blocks, cfg: SAGEConfig) -> torch.Tensor:
    """Minibatch forward over fixed-fanout sampled blocks.

    ``blocks`` = {"feats": (n0, F) input-node features,
                  "nbrs": [(n_{l+1}, fanout_l) indices into layer-l nodes],
                  "self_idx": [(n_{l+1},) index of each dst in layer-l
                  nodes], "mask": [(n_{l+1}, fanout_l) bool]}.
    Layer l maps n_l nodes -> n_{l+1} dst nodes; n_{last} = batch seeds.
    """
    h = blocks["feats"]
    for i, p in enumerate(params["layers"]):
        mask = blocks["mask"][i].to(h.dtype)                 # (nd, f)
        gathered = lookup(h, blocks["nbrs"][i])              # (nd, f, F)
        neigh = (gathered * mask[..., None]).sum(1) \
            / torch.clamp_min(mask.sum(1, keepdim=True), 1.0)
        h_self = lookup(h, blocks["self_idx"][i])
        h = _sage_layer(p, h_self, neigh, is_last=(i == cfg.n_layers - 1))
    return mlp(params["cls"], h)


def forward_batched_graphs(params, x: torch.Tensor, edges: torch.Tensor,
                           edge_mask: torch.Tensor, node_mask: torch.Tensor,
                           cfg: SAGEConfig) -> torch.Tensor:
    """Batched small graphs (the ``molecule`` shape).

    x (B,N,F); edges (B,E,2) per-graph-local (src,dst); edge_mask (B,E);
    node_mask (B,N). Each graph aggregates over its own edges only; graph-
    level mean readout over its unmasked nodes -> (B, n_classes).
    """
    b, n = x.shape[:2]
    off = (torch.arange(b, device=x.device) * n)[:, None]
    src = (edges[..., 0].clamp(0, n - 1) + off).reshape(-1)
    dst_local = edges[..., 1]
    w = (edge_mask.bool() & (dst_local >= 0) & (dst_local < n)).to(x.dtype)
    dst = (dst_local.clamp(0, n - 1) + off).reshape(-1)
    w = w.reshape(-1)
    deg = torch.clamp_min(_segment_sum(w, dst, b * n), 1.0)[:, None]
    h = x.reshape(b * n, -1)
    for i, p in enumerate(params["layers"]):
        msg = lookup(h, src) * w[:, None]
        neigh = _segment_sum(msg, dst, b * n) / deg
        h = _sage_layer(p, h, neigh, is_last=(i == cfg.n_layers - 1))
    m = node_mask.to(h.dtype)[..., None]                     # (B, N, 1)
    pooled = (h.reshape(b, n, -1) * m).sum(1) / torch.clamp_min(m.sum(1),
                                                                1.0)
    return mlp(params["cls"], pooled)


def loss_node(params, batch, cfg: SAGEConfig, mode: str = "full",
              mesh=None, axes=("data",)) -> torch.Tensor:
    """Node-classification cross-entropy: over the ``train_mask``ed nodes
    of the full graph (``mode="full"``; under a mesh, with the edges this
    rank's block over ``axes``), or the mean over the sampled blocks' seeds
    (any other mode)."""
    if mode == "full":
        logits = forward_full(params, batch["feats"], batch["edge_src"],
                              batch["edge_dst"], cfg, mesh=mesh, axes=axes)
        nll = _log_softmax_nll(logits, batch["labels"])
        sel = batch["train_mask"].to(nll.dtype)
        return (nll * sel).sum() / torch.clamp_min(sel.sum(), 1.0)
    logits = forward_sampled(params, batch, cfg)
    return _log_softmax_nll(logits, batch["labels"]).mean()
