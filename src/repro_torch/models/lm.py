"""Decoder-only LM: GQA or MLA attention, dense or MoE FFN, stacked layers,
on torch tensors. Port of ``repro.models.lm``, single device.

One config covers the five LM architectures:

  qwen3-1.7b        GQA(16/8) + qk-norm + SwiGLU
  qwen2-0.5b        GQA(14/2) + QKV bias + SwiGLU
  nemotron-4-15b    GQA(48/8) + squared-ReLU (non-gated) FFN
  qwen3-moe-30b     GQA(32/4, d_head 128) + 128-expert top-8 MoE
  deepseek-v3-671b  MLA + (1 shared + 256 routed top-8) MoE + MTP head

Parameters keep the reference's nested-dict layout, with the leading
``L`` dim of ``dense_layers``/``moe_layers``, so a reference tree
transplants as it is (``weights.from_jax_tree``) and checkpoints name the
same leaves. ``lax.scan`` over the stacked layers is a loop over that dim;
``remat`` checkpoints each layer (``torch.utils.checkpoint``,
non-reentrant), and ``remat_group`` checkpoints groups of layers with each
layer inside checkpointed again.

Entry points: ``init``, ``train_loss``, ``prefill``, ``decode_step``.
Each takes the reference's ``mesh`` argument and raises when it is given:
the mesh branches (context-parallel attention, sequence sharding, the
expert-parallel MoE) are not ported yet (ROADMAP A13b). With ``mesh=None``
the reference runs this same local path (``ep_axis`` and the other mesh
fields of ``LMConfig`` are accepted and have no effect there).

Token ids out of range are clamped (``embedding.layout.lookup``, the
port's one contract), where the reference's ``jnp.take`` fills.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.embedding.layout import lookup
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (decode_attention, flash_attention,
                                          write_slot)
from repro_torch.models.common import (apply_rope, normal_init, rms_init,
                                       rms_norm, rope_angles, squared_relu)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 -> d_model // n_heads
    act: str = "swiglu"                  # swiglu | squared_relu
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False
    # MoE (None -> dense FFN); n_dense_layers leading layers stay dense.
    moe: moe_lib.MoEConfig | None = None
    n_dense_layers: int = 0
    # MLA (None -> GQA)
    mla: mla_lib.MLAConfig | None = None
    # DeepSeek multi-token-prediction head (predicts t+2)
    mtp: bool = False
    mtp_weight: float = 0.3
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 1024
    # the reference's mesh fields (expert parallelism, the 2D serving
    # layout, sequence sharding, context-parallel attention, the batch
    # axes): accepted so that its configs copy verbatim; the local path
    # ignores them, as the reference's does with mesh=None
    ep_axis: str | None = None
    ep_2d: bool = False
    ep_token_chunk: int | None = None
    seq_shard: bool = False
    # two-level remat: groups of ``remat_group`` layers, each group
    # checkpointed, layers within a group checkpointed again — saved
    # residuals drop from L x (B,T,D) to (L/g + g) x (B,T,D).
    remat_group: int | None = None
    context_parallel: bool = False
    batch_axes: tuple = ("pod", "data")

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the LM's mesh branches (context-parallel attention, sequence "
            "sharding, expert-parallel MoE) are not ported yet (ROADMAP "
            "A13b); pass mesh=None for the single-device path")


# ---------------------------------------------------------------- params --
def _init_attn(gen, cfg: LMConfig, dtype):
    if cfg.mla is not None:
        return mla_lib.init_mla(gen, cfg.mla, dtype)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = d ** -0.5
    p = {
        "wq": normal_init(gen, (d, h * dh), s, dtype),
        "wk": normal_init(gen, (d, kv * dh), s, dtype),
        "wv": normal_init(gen, (d, kv * dh), s, dtype),
        "wo": normal_init(gen, (h * dh, d), (h * dh) ** -0.5, dtype),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * dh,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * dh,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = rms_init(dh, dtype, dev)
        p["k_norm"] = rms_init(dh, dtype, dev)
    return p


def _init_ffn(gen, cfg: LMConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {"w_gate": normal_init(gen, (d, f), d ** -0.5, dtype),
                "w_up": normal_init(gen, (d, f), d ** -0.5, dtype),
                "w_down": normal_init(gen, (f, d), f ** -0.5, dtype)}
    return {"w_in": normal_init(gen, (d, f), d ** -0.5, dtype),
            "w_out": normal_init(gen, (f, d), f ** -0.5, dtype)}


def _init_layer(gen, cfg: LMConfig, dtype, use_moe: bool):
    p = {"ln1": rms_init(cfg.d_model, dtype, gen.device),
         "ln2": rms_init(cfg.d_model, dtype, gen.device),
         "attn": _init_attn(gen, cfg, dtype)}
    if use_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg.moe, dtype)
    else:
        p["ffn"] = _init_ffn(gen, cfg, dtype)
    return p


def _stack(make, n: int):
    """``n`` layers of ``make()`` stacked on a leading dim, each copied into
    the stack as it is drawn (the host of the card holds one layer at a
    time beside the stack; a single layer is a view, not a copy)."""
    first = make()
    if n == 1:
        return tree.tree_map(lambda a: a.unsqueeze(0), first)
    out = tree.tree_map(lambda a: a.new_empty((n, *a.shape)), first)
    for i in range(n):
        layer = first if i == 0 else make()
        for dst, src in zip(tree.leaves(out), tree.leaves(layer),
                            strict=True):
            dst[i].copy_(src)
        del layer
    return out


def init(seed: int, cfg: LMConfig, dtype=torch.float32,
         device: str | torch.device = "cuda") -> dict:
    """Random parameters with the reference's distributions, drawn on
    ``device`` from a generator seeded with ``seed`` (not JAX's draws). The
    MoE routers are float32 whatever ``dtype`` is."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    n_dense = cfg.n_dense_layers if cfg.moe is not None else cfg.n_layers
    n_moe = cfg.n_layers - n_dense
    params: dict[str, Any] = {
        "embed": normal_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "final_norm": rms_init(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal_init(gen, (cfg.d_model, cfg.vocab),
                                     cfg.d_model ** -0.5, dtype)
    if n_dense:
        params["dense_layers"] = _stack(
            lambda: _init_layer(gen, cfg, dtype, False), n_dense)
    if n_moe:
        params["moe_layers"] = _stack(
            lambda: _init_layer(gen, cfg, dtype, True), n_moe)
    if cfg.mtp:
        params["mtp"] = {
            "proj": normal_init(gen, (2 * cfg.d_model, cfg.d_model),
                                (2 * cfg.d_model) ** -0.5, dtype),
            "norm": rms_init(cfg.d_model, dtype, gen.device),
            "layer": _init_layer(gen, cfg, dtype, False),
        }
    return params


# --------------------------------------------------------------- forward --
def _rope_qk(q, k, positions, cfg: LMConfig):
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta, q.dtype)
    return (apply_rope(q, cos[:, :, None], sin[:, :, None]),
            apply_rope(k, cos[:, :, None], sin[:, :, None]))


def _qkv(p, x, cfg: LMConfig):
    """The GQA projections of x (B,T,D): q (B,T,H,dh), k/v (B,T,KV,dh),
    with the bias and qk-norm the config asks for (before RoPE)."""
    b, t, _ = x.shape
    out = []
    for w, bias, heads in (("wq", "bq", cfg.n_heads),
                           ("wk", "bk", cfg.n_kv_heads),
                           ("wv", "bv", cfg.n_kv_heads)):
        y = x @ p[w]
        if bias in p:
            y = y + p[bias]
        out.append(y.reshape(b, t, heads, cfg.head_dim))
    q, k, v = out
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["gamma"])
        k = rms_norm(k, p["k_norm"]["gamma"])
    return q, k, v


def _gqa_attention(p, x, cfg: LMConfig, positions):
    b, t, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    out = flash_attention(q, k, v, causal=True,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return out.reshape(b, t, cfg.n_heads * cfg.head_dim) @ p["wo"], (k, v)


def _dense_ffn(p, x, cfg: LMConfig):
    if cfg.act == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return squared_relu(x @ p["w_in"]) @ p["w_out"]


def _ffn(p, h, cfg: LMConfig):
    if "moe" in p:
        return moe_lib.moe_ffn(p["moe"], h, cfg.moe)
    return _dense_ffn(p["ffn"], h, cfg)


def _layer_fwd(p, x, cfg: LMConfig, positions):
    """One block; returns (x, its KV for the cache)."""
    if cfg.mla is not None:
        attn, kv = mla_lib.mla_attention(
            p["attn"], rms_norm(x, p["ln1"]["gamma"]), cfg.mla, positions)
    else:
        attn, kv = _gqa_attention(p["attn"], rms_norm(x, p["ln1"]["gamma"]),
                                  cfg, positions)
    x = x + attn
    return x + _ffn(p, rms_norm(x, p["ln2"]["gamma"]), cfg), kv


def _layer(stacked, i: int):
    return tree.tree_map(lambda a: a[i], stacked)


def _scan_layers(stacked, x, cfg: LMConfig, positions,
                 with_cache: bool = False):
    """The layers of ``stacked`` in order over x; returns (x, [KV per
    layer]) with ``with_cache``, else (x, None)."""
    n_layers = tree.leaves(stacked)[0].shape[0]
    remat = torch.is_grad_enabled() and not with_cache

    def body(carry, i):
        y, _ = _layer_fwd(_layer(stacked, i), carry, cfg, positions)
        return y

    def step(carry, i):
        if remat and cfg.remat:
            return checkpoint(body, carry, i, use_reentrant=False)
        return body(carry, i)

    if with_cache:
        kvs = []
        for i in range(n_layers):
            x, kv = _layer_fwd(_layer(stacked, i), x, cfg, positions)
            kvs.append(kv)
        return x, kvs
    g = cfg.remat_group
    if g and 1 < g < n_layers and n_layers % g == 0:
        def group(carry, lo):
            for i in range(lo, lo + g):
                carry = step(carry, i)
            return carry

        for lo in range(0, n_layers, g):
            x = checkpoint(group, x, lo, use_reentrant=False) if remat \
                else group(x, lo)
        return x, None
    for i in range(n_layers):
        x = step(x, i)
    return x, None


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device)[None].expand(b, t)


def backbone(params, tokens, cfg: LMConfig, mesh=None, positions=None,
             with_cache: bool = False):
    """tokens (B,T) -> final hidden (B,T,D) [+ the KV of every layer]."""
    _no_mesh(mesh)
    b, t = tokens.shape
    if positions is None:
        positions = _positions(b, t, tokens.device)
    x = lookup(params["embed"], tokens)
    caches = []
    for name in ("dense_layers", "moe_layers"):
        if name in params:
            x, kv = _scan_layers(params[name], x, cfg, positions, with_cache)
            caches.extend(kv or [])
    x = rms_norm(x, params["final_norm"]["gamma"])
    return (x, caches) if with_cache else x


def logits_fn(params, hidden, cfg: LMConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return hidden @ head


def _ce_sum(params, h, tgt, w, cfg: LMConfig):
    logits = logits_fn(params, h, cfg).float()
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return (nll * w).sum()


def chunked_ce(params, hidden, targets, cfg: LMConfig, t_chunk: int = 512,
               weights=None):
    """Mean token NLL with seq-chunked logits (memory-efficient CE).

    ``hidden`` (B,T,D), ``targets`` (B,T). T is padded up to a multiple of
    ``t_chunk`` (padded positions weigh 0), and the (B, t_chunk, V) logits
    block is the only vocab-sized tensor alive at once: each chunk is
    checkpointed, so the backward recomputes it instead of keeping (B, T,
    V) logits.
    """
    b, t, _ = hidden.shape
    if weights is None:
        weights = torch.ones((b, t), dtype=torch.float32,
                             device=hidden.device)
    pad = (-t) % t_chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        weights = F.pad(weights, (0, pad))
    acc = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, t + pad, t_chunk):
        args = (params, hidden[:, lo:lo + t_chunk],
                targets[:, lo:lo + t_chunk], weights[:, lo:lo + t_chunk], cfg)
        acc = acc + (checkpoint(_ce_sum, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else _ce_sum(*args))
    return acc / weights.sum().clamp_min(1.0)


def train_loss(params, batch, cfg: LMConfig, mesh=None):
    """batch: {tokens (B,T), targets (B,T)}; mean next-token CE (+ MTP)."""
    tokens, targets = batch["tokens"], batch["targets"]
    hidden = backbone(params, tokens, cfg, mesh)
    loss = chunked_ce(params, hidden, targets, cfg)
    if cfg.mtp and "mtp" in params:
        # predict t+2: combine h_t with emb(t+1), one extra block.
        emb_next = lookup(params["embed"], tokens)
        h = torch.cat([hidden[:, :-1], emb_next[:, 1:]], -1) \
            @ params["mtp"]["proj"]
        h = rms_norm(h, params["mtp"]["norm"]["gamma"])
        b, tm1, _ = h.shape
        h, _ = _layer_fwd(params["mtp"]["layer"], h, cfg,
                          _positions(b, tm1, h.device))
        # position i of h fuses hidden_i with emb(token_{i+1}) and predicts
        # token_{i+2} = targets[i+1], for i in [0, T-2].
        loss = loss + cfg.mtp_weight * chunked_ce(
            params, h, targets[:, 1:], cfg)
    return loss


# ---------------------------------------------------------------- decode --
def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    if cfg.mla is not None:
        return {
            "c": torch.zeros((cfg.n_layers, batch, max_len,
                              cfg.mla.kv_lora_rank), dtype=dtype, device=dev),
            "kr": torch.zeros((cfg.n_layers, batch, max_len,
                               cfg.mla.rope_head_dim), dtype=dtype,
                              device=dev),
        }
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _decode_layer(p, x, cache_slice, length, cfg: LMConfig):
    """x (B,1,D) one layer; writes the token's KV into ``cache_slice`` (one
    layer's cache) in place and returns x."""
    b = x.shape[0]
    h = rms_norm(x, p["ln1"]["gamma"])
    if cfg.mla is not None:
        attn, _, _ = mla_lib.mla_decode(p["attn"], h, cache_slice["c"],
                                        cache_slice["kr"], length, cfg.mla)
    else:
        q, k, v = _qkv(p["attn"], h, cfg)
        pos = torch.full((b, 1), int(length), dtype=torch.int32,
                         device=x.device)
        q, k = _rope_qk(q, k, pos, cfg)
        write_slot(cache_slice["k"], k, length)
        write_slot(cache_slice["v"], v, length)
        out = decode_attention(q[:, 0], cache_slice["k"], cache_slice["v"],
                               int(length) + 1)
        attn = out.reshape(b, 1, cfg.n_heads * cfg.head_dim) \
            @ p["attn"]["wo"]
    x = x + attn
    return x + _ffn(p, rms_norm(x, p["ln2"]["gamma"]), cfg)


def decode_step(params, cache, tokens, length, cfg: LMConfig, mesh=None):
    """One serve step: tokens (B,) int, ``length`` (an int) tokens already
    cached.

    Returns (logits (B,V), cache). The cache is updated in place (the
    reference's serve step donates it) and returned. The token's KV goes
    into slot ``length``; at or past the cache's end it overwrites the
    last slot, with RoPE still at position ``length``, and the step
    returns finite logits: the reference's ``dynamic_update_slice`` clamps
    its index the same way, so the two agree there too.
    """
    _no_mesh(mesh)
    x = lookup(params["embed"], tokens[:, None])
    offset = 0
    for name in ("dense_layers", "moe_layers"):
        if name not in params:
            continue
        stacked = params[name]
        for i in range(tree.leaves(stacked)[0].shape[0]):
            layer_cache = {k: c[offset + i] for k, c in cache.items()}
            x = _decode_layer(_layer(stacked, i), x, layer_cache, length,
                              cfg)
        offset += tree.leaves(stacked)[0].shape[0]
    x = rms_norm(x, params["final_norm"]["gamma"])
    return logits_fn(params, x[:, 0], cfg), cache


def prefill(params, tokens, cfg: LMConfig, mesh=None):
    """tokens (B,T) -> (last-position logits (B,V), stacked caches of
    exactly T slots in the compute dtype)."""
    hidden, caches = backbone(params, tokens, cfg, mesh, with_cache=True)
    names = ("c", "kr") if cfg.mla is not None else ("k", "v")
    cache = {n: torch.stack([kv[i] for kv in caches])
             for i, n in enumerate(names)}
    return logits_fn(params, hidden[:, -1], cfg), cache
