"""BERT4Rec (arXiv:1904.06690), a bidirectional transformer over item
sequences, on torch tensors.

Cloze training: random positions are masked and predicted with a full
softmax over the item vocabulary through the tied item-embedding matrix.
Serving scores the last position's hidden state against candidate items
(dot product); it is encoder-only, so there is no autoregressive decode
path. Assigned config: d=64, 2 blocks, 2 heads, seq 200. Port of
``repro.models.bert4rec``: the same functions on the same param tree
(transplant the reference's with ``repro_torch.weights.from_jax_tree``).

Plain PyTorch, as the reference is plain ``jnp``. Written as the reference
writes it: the attention's softmax in float32, cast back; ``jax.nn.gelu``'s
default, the tanh approximation; the reference's ``layer_norm``. An item id
out of range is clamped (``embedding.layout.lookup``), where the
reference's ``jnp.take`` fills.

Under a ``distributed.mesh.Mesh`` (``mesh=``) each rank holds its ``(n_items
/ n, D)`` row block of ``items`` (the reference's ``P("model", None)``,
``src/repro/configs/bert4rec_arch.py:21``) and its rows of the batch, the
rest of the params whole. The input lookup is
``embedding.sharded.row_parallel_lookup`` (a masked local lookup summed
over ``model``), the encoder runs replicated over ``model``, and the tied
output product runs on the rank's vocab block: the cloze loss takes its
logsumexp and the target's logit across the blocks
(``embedding.sharded.vocab_parallel_nll``), ``score`` gathers the blocks'
logits over ``model``. The hidden state enters the product through
``in_boundary``, so that each rank's cotangent of it is the sum of every
block's, and each ``model`` rank holds the whole cotangent of the
encoder: a param's gradient block is the rank's rows' share, to be summed
over the batch axes only (``configs.recsys_common``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import (all_gather, in_boundary,
                                          out_boundary, psum)
from repro_torch.distributed.shardings import P
from repro_torch.embedding.sharded import (row_parallel_lookup,
                                           vocab_parallel_nll)
from repro_torch.models.common import (dense, dense_init, layer_norm,
                                       ln_init, make_generator, normal_init)


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    n_items: int = 26_744          # ML-20m item count (paper's dataset)
    d_ff: int = 256                # 4x
    mask_token: int = 0            # item 0 reserved as [mask]

    def flops_per_sample(self) -> int:
        d, t = self.embed_dim, self.seq_len
        per_block = 2 * t * (4 * d * d) + 2 * t * t * d * 2 \
            + 2 * t * (2 * d * self.d_ff)
        return self.n_blocks * per_block + 2 * t * d * self.n_items


def init(seed: int, cfg: Bert4RecConfig, dtype=torch.float32,
         device: str | torch.device = "cuda") -> dict:
    """Random parameters with the reference's distributions, drawn on
    ``device`` from a generator seeded with ``seed`` (not JAX's draws)."""
    gen = make_generator(seed, resolve_device(device))
    d = cfg.embed_dim
    params = {
        "items": normal_init(gen, (cfg.n_items, d), 0.02, dtype),
        "pos": normal_init(gen, (cfg.seq_len, d), 0.02, dtype),
        "blocks": [],
        "final_ln": ln_init(d, dtype, gen.device),
    }
    for _ in range(cfg.n_blocks):
        params["blocks"].append({
            "wq": dense_init(gen, d, d, dtype, bias=True),
            "wk": dense_init(gen, d, d, dtype, bias=True),
            "wv": dense_init(gen, d, d, dtype, bias=True),
            "wo": dense_init(gen, d, d, dtype, bias=True),
            "ln1": ln_init(d, dtype, gen.device),
            "ff1": dense_init(gen, d, cfg.d_ff, dtype, bias=True),
            "ff2": dense_init(gen, cfg.d_ff, d, dtype, bias=True),
            "ln2": ln_init(d, dtype, gen.device),
        })
    return params


def _item_logits(params, h: torch.Tensor, mesh) -> torch.Tensor:
    """h (..., D) against the tied item matrix: (..., n_items), under a mesh
    the rank's vocab block (..., n_items / n), ``h`` through
    ``in_boundary``."""
    if mesh is None:
        return h @ params["items"].T
    return in_boundary(h, mesh, "model") @ params["items"].T


def encode(params, items: torch.Tensor, pad_mask: torch.Tensor,
           cfg: Bert4RecConfig, mesh=None) -> torch.Tensor:
    """items (B,T) int, pad_mask (B,T) bool -> hidden (B,T,D). Every
    position attends to every unpadded one (bidirectional)."""
    b, t = items.shape
    d, h = cfg.embed_dim, cfg.n_heads
    dh = d // h
    x = row_parallel_lookup(params["items"], items, mesh) \
        + params["pos"][None, :t]
    for blk in params["blocks"]:
        q = dense(blk["wq"], x).reshape(b, t, h, dh)
        k = dense(blk["wk"], x).reshape(b, t, h, dh)
        v = dense(blk["wv"], x).reshape(b, t, h, dh)
        logits = torch.einsum("bthd,bshd->bhts", q, k) * dh ** -0.5
        logits = torch.where(pad_mask[:, None, None, :], logits, -1e30)
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        attn = torch.einsum("bhts,bshd->bthd", w, v).reshape(b, t, d)
        x = layer_norm(x + dense(blk["wo"], attn),
                       blk["ln1"]["gamma"], blk["ln1"]["beta"])
        ff = dense(blk["ff2"], F.gelu(dense(blk["ff1"], x),
                                      approximate="tanh"))
        x = layer_norm(x + ff, blk["ln2"]["gamma"], blk["ln2"]["beta"])
    return layer_norm(x, params["final_ln"]["gamma"],
                      params["final_ln"]["beta"])


def cloze_terms(params, batch, cfg: Bert4RecConfig, mesh=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cloze loss's two sums: the NLL over the valid masked positions,
    and their count (``loss`` is the one over the other, at least 1); under
    a mesh the rank's rows' sums, the logits on its vocab block."""
    hidden = encode(params, batch["items"], batch["pad_mask"], cfg, mesh)
    h = torch.take_along_dim(hidden, batch["mask_pos"][..., None].long(),
                             dim=1)                         # (B, M, D)
    logits = _item_logits(params, h, mesh).float()
    if mesh is None:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.take_along_dim(logp, batch["targets"][..., None].long(),
                                    dim=-1)[..., 0]
    else:
        nll = vocab_parallel_nll(logits, batch["targets"], mesh)
    m = batch["target_mask"].float()
    return (nll * m).sum(), m.sum()


def loss(params, batch, cfg: Bert4RecConfig, mesh=None, axes=("data",)
         ) -> torch.Tensor:
    """Cloze loss over gathered masked positions.

    batch: items (B,T) with [mask] inserted, mask_pos (B,M) int positions,
    targets (B,M) true ids at those positions, target_mask (B,M) bool
    (valid entries), pad_mask (B,T) bool. Only the M gathered positions
    are scored against the vocabulary: (B, M, V) logits, not (B, T, V).
    Under a mesh the whole batch's loss: the NLL sum and the count each
    summed over ``axes``, the ratio's cotangent divided over ``axes`` alone
    (``out_boundary`` of a ``P("model")`` output).
    """
    nll, count = cloze_terms(params, batch, cfg, mesh)
    if mesh is None:
        return nll / torch.clamp_min(count, 1.0)
    ratio = psum(nll, mesh, axes) / torch.clamp_min(psum(count, mesh, axes),
                                                    1.0)
    return out_boundary(ratio, mesh, P("model"))


def score(params, batch, cfg: Bert4RecConfig, mesh=None) -> torch.Tensor:
    """Next-item scores for serving: (B, n_items) logits of the last
    (mask-appended) position; under a mesh the rank's rows, the vocab
    blocks gathered over ``model``."""
    hidden = encode(params, batch["items"], batch["pad_mask"], cfg, mesh)
    logits = _item_logits(params, hidden[:, -1], mesh)
    return logits if mesh is None else all_gather(logits, mesh, "model", -1)


def retrieval_score(params, batch, cfg: Bert4RecConfig, mesh=None
                    ) -> torch.Tensor:
    """One user vs N candidate item ids (``candidates`` (N,)) -> (N,);
    under a mesh the rank's block of the candidates."""
    hidden = encode(params, batch["items"], batch["pad_mask"], cfg, mesh)
    last = hidden[:, -1]                                    # (1, D)
    cands = row_parallel_lookup(params["items"], batch["candidates"], mesh)
    return (last @ cands.T)[0]
