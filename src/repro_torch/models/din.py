"""DIN, the Deep Interest Network (arXiv:1706.06978), on torch tensors.

Target attention over the user behaviour sequence: for each candidate ad,
an attention MLP scores every history item against the target via
``concat[hist, target, hist - target, hist * target]``, the weighted sum
pools the history, and ``[pooled, target, pooled * target, profile]`` feeds
the prediction MLP. Assigned config: embed_dim=18, seq_len=100, attn MLP
80-40, main MLP 200-80. Port of ``repro.models.din``: the same functions on
the same param tree (transplant the reference's with
``repro_torch.weights.from_jax_tree``).

The model is plain PyTorch: the reference's is plain ``jnp`` (gathers, an
MLP, a softmax), with no TPU kernel to port. An item id out of range is
clamped into ``[0, n_items)`` (``embedding.layout.lookup``), where the
reference's ``jnp.take`` fills. ``retrieval_score`` takes the candidates in
chunks (``RETRIEVAL_CHUNK``), so that its memory does not grow with their
number.

Under a ``distributed.mesh.Mesh`` (``mesh=``) each rank holds its ``(n_items
/ n, D)`` row block of ``items`` (the reference's ``P("model", None)``,
``src/repro/configs/din_arch.py:17``) and its rows of the batch; every
lookup is ``embedding.sharded.row_parallel_lookup``, a masked local lookup
summed over ``model``, after which the attention and the MLPs run
replicated over ``model``. Each ``model`` rank then holds the whole
cotangent of those activations, so a param's gradient block is the rank's
rows' share, to be summed over the batch axes only
(``configs.recsys_common``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import out_boundary, psum
from repro_torch.distributed.shardings import P
from repro_torch.embedding.sharded import row_parallel_lookup
from repro_torch.models.common import (bce_with_logits, make_generator, mlp,
                                       mlp_init, uniform_init)

# candidates per chunk of retrieval_score: each holds its (L, 4D) attention
# features and (L, 80 + 40) hidden activations, about 0.1 MB per candidate
# in float32 at seq_len 100, so a chunk takes a few GB where all of 1M
# candidates at once would take some 60 GB
RETRIEVAL_CHUNK = 32_768


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    n_items: int = 1_000_000
    n_profile: int = 8          # dense user-profile features

    @property
    def mlp_in(self) -> int:
        return 3 * self.embed_dim + self.n_profile

    def flops_per_sample(self) -> int:
        d = self.embed_dim
        a_in = 4 * d
        sizes = (a_in,) + tuple(self.attn_mlp) + (1,)
        attn = self.seq_len * sum(2 * x * y
                                  for x, y in zip(sizes[:-1], sizes[1:], strict=True))
        msz = (self.mlp_in,) + tuple(self.mlp) + (1,)
        main = sum(2 * x * y for x, y in zip(msz[:-1], msz[1:], strict=True))
        return attn + main + 2 * self.seq_len * d


def init(seed: int, cfg: DINConfig, dtype=torch.float32,
         device: str | torch.device = "cuda") -> dict:
    """Random parameters with the reference's distributions, drawn on
    ``device`` from a generator seeded with ``seed`` (not JAX's draws)."""
    gen = make_generator(seed, resolve_device(device))
    scale = cfg.n_items ** -0.5
    return {
        "items": uniform_init(gen, (cfg.n_items, cfg.embed_dim), scale,
                              dtype),
        "attn": mlp_init(gen, (4 * cfg.embed_dim,) + tuple(cfg.attn_mlp)
                         + (1,), dtype),
        "mlp": mlp_init(gen, (cfg.mlp_in,) + tuple(cfg.mlp) + (1,), dtype),
    }


def _target_attention(params, hist: torch.Tensor, target: torch.Tensor,
                      hist_mask: torch.Tensor) -> torch.Tensor:
    """hist (..., L, D), target (..., D) -> pooled (..., D); masked history
    positions get a score of -1e30, so a softmax weight of 0."""
    t = target[..., None, :].expand(hist.shape)
    feat = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    scores = mlp(params["attn"], feat)[..., 0]              # (..., L)
    scores = torch.where(hist_mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("...l,...ld->...d", w, hist)


def forward(params, batch, cfg: DINConfig, mesh=None) -> torch.Tensor:
    """batch: hist (B,L) int, hist_mask (B,L) bool, target (B,) int,
    profile (B,n_profile) float -> logits (B,); under a mesh the rank's
    rows of each."""
    items = params["items"]
    hist = row_parallel_lookup(items, batch["hist"], mesh)         # (B,L,D)
    target = row_parallel_lookup(items, batch["target"], mesh)     # (B,D)
    pooled = _target_attention(params, hist, target, batch["hist_mask"])
    feat = torch.cat([pooled, target, pooled * target, batch["profile"]],
                     dim=-1)
    return mlp(params["mlp"], feat)[:, 0]


def loss(params, batch, cfg: DINConfig, mesh=None, axes=("data",)
         ) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``labels``
    (``models.common.bce_with_logits``: the reference's formula and its
    gradient at a zero logit). Under a mesh the whole batch's mean, the
    mean of the ranks' equal blocks over ``axes``, its cotangent divided
    over ``axes`` alone (``out_boundary`` of a ``P("model")`` output), so
    that each rank's backward is its rows' share of the mean."""
    part = torch.mean(bce_with_logits(forward(params, batch, cfg, mesh),
                                      batch["labels"]))
    if mesh is None:
        return part
    return out_boundary(psum(part, mesh, axes) / mesh.axis_size(axes), mesh,
                        P("model"))


def retrieval_score(params, batch, cfg: DINConfig, mesh=None
                    ) -> torch.Tensor:
    """One user vs N candidates: target attention per candidate.

    batch: hist (1,L), hist_mask (1,L), profile (1,P), candidates (N,).
    The user's history is broadcast over the candidates (a stride-0 view),
    ``RETRIEVAL_CHUNK`` candidates at a time; each candidate's score is
    computed from its own row alone, so the chunks change no result, only
    the peak memory. Returns (N,) logits. Under a mesh ``candidates`` are
    the rank's block, the same on every rank of ``model``, so the ranks of
    a ``model`` group run the same chunks and collectives.
    """
    hist = row_parallel_lookup(params["items"], batch["hist"][0],
                               mesh)                           # (L,D)
    mask = batch["hist_mask"][0]
    prof = batch["profile"]
    out = []
    for ids in batch["candidates"].split(RETRIEVAL_CHUNK):
        cands = row_parallel_lookup(params["items"], ids, mesh)  # (n,D)
        n = cands.shape[0]
        pooled = _target_attention(params, hist.expand(n, *hist.shape),
                                   cands, mask.expand(n, mask.shape[0]))
        feat = torch.cat([pooled, cands, pooled * cands,
                          prof.expand(n, prof.shape[-1])], dim=-1)
        out.append(mlp(params["mlp"], feat)[:, 0])
    return torch.cat(out)
