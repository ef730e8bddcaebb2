"""Decoder-only LM: GQA or MLA attention, dense or MoE FFN, stacked layers,
on torch tensors. Port of ``repro.models.lm``.

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

Entry points: ``init``, ``train_loss``, ``prefill``, ``decode_step``,
each with the reference's ``mesh`` argument. ``mesh=None`` is the local
path (the mesh fields of ``LMConfig`` have no effect there, as in the
reference). Under a ``distributed.mesh.Mesh`` each ``torch.distributed``
rank runs the reference's ``shard_map`` regions on its blocks:

- the MoE layers' expert parallelism where ``ep_axis`` is set
  (``moe_ffn_sharded``, or the 2D serving layout ``moe_ffn_2d`` with
  ``ep_2d`` and ``ep_token_chunk``);
- context-parallel attention where ``context_parallel`` is set and T
  divides the ``model`` axis (the rank's T block of queries against all
  keys);
- sequence sharding of the residual stream between layers with
  ``seq_shard`` (off with a cache, as in the reference).

The reference leaves everything outside those regions to GSPMD. The port
fixes one layout there: each rank holds its rows of the batch
(``cfg.batch_axes``; tokens, caches, hidden states and logits), the same
on every rank of the other axes, and the params whole; the dense parts run
on those rows with the whole params, alike on each rank of ``model``.
Megatron tensor parallelism of the dense parts is not ported (ROADMAP
P9). A region cuts its blocks of params and activations by the
reference's in_specs and rejoins the layout at its out_spec. Its
boundaries carry the gradients: an input's cotangent is summed over the
axes that replicate it (``distributed.mesh.in_boundary``), an output's is
divided by them (``out_boundary``), and the context-parallel gather cuts
its cotangent back to the rank's block (``gather_blocks``). So after a
backward each rank holds the gradient of its own rows' share of the loss,
the same on every rank of ``model``, and a sum over the batch axes (the
data-parallel all-reduce) gives the reference's ``jax.grad``.

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
from repro_torch.distributed.mesh import (Mesh, gather_blocks, in_boundary,
                                          out_boundary, own_block, psum)
from repro_torch.distributed.shardings import P, NamedSharding
from repro_torch.embedding.layout import lookup
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (decode_attention, flash_attention,
                                          write_slot)
from repro_torch.models.common import (apply_rope, make_generator,
                                       normal_init, rms_init, rms_norm,
                                       rope_angles, squared_relu)


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
    # the mesh fields (expert parallelism, the 2D serving layout,
    # sequence sharding, context-parallel attention, the batch axes); the
    # local path ignores them, as the reference's does with mesh=None
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


def _check_mesh(mesh, cfg: LMConfig) -> None:
    """A mesh is None or a ``Mesh`` whose axes are ``cfg.batch_axes`` and
    ``model``, the layout's two kinds."""
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a repro_torch.distributed.mesh.Mesh "
                        f"or None, not {type(mesh).__name__}")
    if sorted(mesh.axis_names) != sorted((*cfg.batch_axes, "model")):
        raise ValueError(f"the LM's layout needs a mesh of the batch axes "
                         f"{cfg.batch_axes} and 'model'; this one has "
                         f"{mesh.axis_names}")


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
    MoE routers are float32 whatever ``dtype`` is. On ``meta`` it builds
    the shapes only, allocating nothing (a plan's full-size model)."""
    gen = make_generator(seed, resolve_device(device))
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


def _cp_attention(q, k, v, cfg: LMConfig, mesh):
    """Context-parallel attention (``repro/models/lm.py:169-184``): this
    rank's T block of queries over ``model`` against every key, at its
    global offset; the blocks rejoin over ``model`` on T."""
    t_loc = q.shape[1] // mesh.axis_size("model")
    out = flash_attention(
        own_block(q, mesh, "model", 1), in_boundary(k, mesh, "model"),
        in_boundary(v, mesh, "model"), causal=True,
        q_chunk=min(cfg.q_chunk, t_loc), kv_chunk=cfg.kv_chunk,
        q_start=mesh.axis_index("model") * t_loc)
    return gather_blocks(out, mesh, "model", 1)


def _gqa_attention(p, x, cfg: LMConfig, positions, mesh=None):
    b, t, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    if cfg.context_parallel and mesh is not None \
            and t % mesh.shape["model"] == 0:
        out = _cp_attention(q, k, v, cfg, mesh)
    else:
        out = flash_attention(q, k, v, causal=True,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return out.reshape(b, t, cfg.n_heads * cfg.head_dim) @ p["wo"], (k, v)


def _dense_ffn(p, x, cfg: LMConfig):
    if cfg.act == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return squared_relu(x @ p["w_in"]) @ p["w_out"]


def _moe_specs(cfg: LMConfig) -> dict:
    """The in_specs of one MoE layer's params under EP
    (``repro/models/lm.py:217-227``)."""
    ep = cfg.ep_axis
    specs = {"router": P(), "w_gate": P(ep), "w_up": P(ep), "w_down": P(ep)}
    if cfg.moe.n_shared:
        specs["shared"] = {"w_gate": {"w": P(None, ep)},
                           "w_up": {"w": P(None, ep)},
                           "w_down": {"w": P(ep, None)}}
    if cfg.moe.router_bias:
        specs["router_b"] = P()
    return specs


def _moe_specs_2d(cfg: LMConfig) -> dict:
    """The in_specs of the serving layout, ``moe_ffn_2d``'s
    (``repro/models/lm.py:230-243``)."""
    ep = cfg.ep_axis
    specs = {"router": P(),
             "w_gate": P(ep, None, "data"),
             "w_up": P(ep, None, "data"),
             "w_down": P(ep, "data", None)}
    if cfg.moe.n_shared:
        specs["shared"] = {"w_gate": {"w": P(None, ("data", ep))},
                           "w_up": {"w": P(None, ("data", ep))},
                           "w_down": {"w": P(("data", ep), None)}}
    if cfg.moe.router_bias:
        specs["router_b"] = P()
    return specs


def _moe_block(p, x, cfg: LMConfig, mesh):
    """The MoE FFN (``repro/models/lm.py:247-264``): local without a mesh or
    ``ep_axis``, else the rank's blocks of ``p`` by the specs through
    ``moe_ffn_2d`` (``ep_2d``) or ``moe_ffn_sharded`` on its rows ``x``.
    Each cut's cotangent is summed over ``model``, whose ranks share the
    work, and the output's divided by it, since all of them use it."""
    if cfg.ep_axis is None or mesh is None:
        return moe_lib.moe_ffn(p, x, cfg.moe)
    specs = _moe_specs_2d(cfg) if cfg.ep_2d else _moe_specs(cfg)
    blocks = tree.tree_map(
        lambda a, s: NamedSharding(mesh, s).shard(
            in_boundary(a, mesh, "model")), p, specs)
    x = in_boundary(x, mesh, "model")
    if cfg.ep_2d:
        y = moe_lib.moe_ffn_2d(blocks, x, cfg.moe, model_axis=cfg.ep_axis,
                               data_axis="data", batch_axes=cfg.batch_axes,
                               token_chunk=cfg.ep_token_chunk, mesh=mesh)
    else:
        y = moe_lib.moe_ffn_sharded(blocks, x, cfg.moe,
                                    axis_name=cfg.ep_axis, mesh=mesh)
    return out_boundary(y, mesh, P(cfg.batch_axes, None, None))


def _ffn(p, h, cfg: LMConfig, mesh):
    if "moe" in p:
        return _moe_block(p["moe"], h, cfg, mesh)
    return _dense_ffn(p["ffn"], h, cfg)


def _layer_fwd(p, x, cfg: LMConfig, positions, mesh=None):
    """One block; returns (x, its KV for the cache). MLA takes no mesh,
    as in the reference."""
    if cfg.mla is not None:
        attn, kv = mla_lib.mla_attention(
            p["attn"], rms_norm(x, p["ln1"]["gamma"]), cfg.mla, positions)
    else:
        attn, kv = _gqa_attention(p["attn"], rms_norm(x, p["ln1"]["gamma"]),
                                  cfg, positions, mesh)
    x = x + attn
    return x + _ffn(p, rms_norm(x, p["ln2"]["gamma"]), cfg, mesh), kv


def _layer(stacked, i: int):
    return tree.tree_map(lambda a: a[i], stacked)


def _scan_layers(stacked, x, cfg: LMConfig, positions, mesh=None,
                 with_cache: bool = False):
    """The layers of ``stacked`` in order over x; returns (x, [KV per
    layer]) with ``with_cache``, else (x, None).

    With ``seq_shard`` under a mesh (``repro/models/lm.py:281-314``; not
    with a cache) each rank keeps its (B, T / n_model, D) block of the
    residual stream between layers, so that a checkpoint holds that block
    only, and gathers it over ``model`` at each layer's input."""
    n_layers = tree.leaves(stacked)[0].shape[0]
    remat = torch.is_grad_enabled() and not with_cache
    sp = cfg.seq_shard and mesh is not None and not with_cache

    def body(carry, i):
        if sp:
            carry = gather_blocks(carry, mesh, "model", 1)
        y, _ = _layer_fwd(_layer(stacked, i), carry, cfg, positions, mesh)
        return own_block(y, mesh, "model", 1) if sp else y

    def step(carry, i):
        if remat and cfg.remat:
            return checkpoint(body, carry, i, use_reentrant=False)
        return body(carry, i)

    if with_cache:
        kvs = []
        for i in range(n_layers):
            x, kv = _layer_fwd(_layer(stacked, i), x, cfg, positions, mesh)
            kvs.append(kv)
        return x, kvs
    if sp:
        x = own_block(x, mesh, "model", 1)
    g = cfg.remat_group
    if g and 1 < g < n_layers and n_layers % g == 0:
        def group(carry, lo):
            for i in range(lo, lo + g):
                carry = step(carry, i)
            return carry

        for lo in range(0, n_layers, g):
            x = checkpoint(group, x, lo, use_reentrant=False) if remat \
                else group(x, lo)
    else:
        for i in range(n_layers):
            x = step(x, i)
    return (gather_blocks(x, mesh, "model", 1) if sp else x), None


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device)[None].expand(b, t)


def backbone(params, tokens, cfg: LMConfig, mesh=None, positions=None,
             with_cache: bool = False):
    """tokens (B,T) -> final hidden (B,T,D) [+ the KV of every layer].
    Under a mesh, ``tokens`` are this rank's rows (module docstring)."""
    _check_mesh(mesh, cfg)
    b, t = tokens.shape
    if positions is None:
        positions = _positions(b, t, tokens.device)
    x = lookup(params["embed"], tokens)
    caches = []
    for name in ("dense_layers", "moe_layers"):
        if name in params:
            x, kv = _scan_layers(params[name], x, cfg, positions, mesh,
                                 with_cache)
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
    acc, total = _ce_terms(params, hidden, targets, cfg, t_chunk, weights)
    return acc / total.clamp_min(1.0)


def _ce_terms(params, hidden, targets, cfg: LMConfig, t_chunk: int = 512,
              weights=None):
    """``chunked_ce``'s weighted NLL sum and its weights' sum."""
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
    return acc, weights.sum()


def _mean_nll(params, hidden, targets, cfg: LMConfig, mesh):
    """``chunked_ce`` over the whole batch: under a mesh, each rank's rows
    over every rank's weight, summed over the batch axes. The sum's
    cotangent is divided over the batch axes (``out_boundary``), so that
    each rank's backward is its own rows' share of the mean."""
    if mesh is None:
        return chunked_ce(params, hidden, targets, cfg)
    acc, total = _ce_terms(params, hidden, targets, cfg)
    share = acc / psum(total, mesh, cfg.batch_axes).clamp_min(1.0)
    return out_boundary(psum(share, mesh, cfg.batch_axes), mesh, P("model"))


def train_loss(params, batch, cfg: LMConfig, mesh=None):
    """batch: {tokens (B,T), targets (B,T)}; mean next-token CE (+ MTP).

    Under a mesh ``batch`` holds this rank's rows; the loss is the whole
    batch's mean on every rank, and its gradient the rank's share (module
    docstring)."""
    tokens, targets = batch["tokens"], batch["targets"]
    hidden = backbone(params, tokens, cfg, mesh)
    loss = _mean_nll(params, hidden, targets, cfg, mesh)
    if cfg.mtp and "mtp" in params:
        # predict t+2: combine h_t with emb(t+1), one extra block.
        emb_next = lookup(params["embed"], tokens)
        h = torch.cat([hidden[:, :-1], emb_next[:, 1:]], -1) \
            @ params["mtp"]["proj"]
        h = rms_norm(h, params["mtp"]["norm"]["gamma"])
        b, tm1, _ = h.shape
        h, _ = _layer_fwd(params["mtp"]["layer"], h, cfg,
                          _positions(b, tm1, h.device), mesh)
        # position i of h fuses hidden_i with emb(token_{i+1}) and predicts
        # token_{i+2} = targets[i+1], for i in [0, T-2].
        loss = loss + cfg.mtp_weight * _mean_nll(
            params, h, targets[:, 1:], cfg, mesh)
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


def _decode_layer(p, x, cache_slice, length, cfg: LMConfig, mesh=None):
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
    return x + _ffn(p, rms_norm(x, p["ln2"]["gamma"]), cfg, mesh)


def decode_step(params, cache, tokens, length, cfg: LMConfig, mesh=None):
    """One serve step: tokens (B,) int, ``length`` (an int) tokens already
    cached.

    Returns (logits (B,V), cache). The cache is updated in place (the
    reference's serve step donates it) and returned. The token's KV goes
    into slot ``length``; at or past the cache's end it overwrites the
    last slot, with RoPE still at position ``length``, and the step
    returns finite logits: the reference's ``dynamic_update_slice`` clamps
    its index the same way, so the two agree there too.

    Under a mesh ``tokens`` and the cache hold this rank's batch rows (the
    cache's sequence axis is whole; the plans' cache specs split it over
    ``model`` for GSPMD, which the port leaves out), and so do the logits.
    """
    _check_mesh(mesh, cfg)
    x = lookup(params["embed"], tokens[:, None])
    offset = 0
    for name in ("dense_layers", "moe_layers"):
        if name not in params:
            continue
        stacked = params[name]
        for i in range(tree.leaves(stacked)[0].shape[0]):
            layer_cache = {k: c[offset + i] for k, c in cache.items()}
            x = _decode_layer(_layer(stacked, i), x, layer_cache, length,
                              cfg, mesh)
        offset += tree.leaves(stacked)[0].shape[0]
    x = rms_norm(x, params["final_norm"]["gamma"])
    return logits_fn(params, x[:, 0], cfg), cache


def prefill(params, tokens, cfg: LMConfig, mesh=None):
    """tokens (B,T) -> (last-position logits (B,V), stacked caches of
    exactly T slots in the compute dtype); under a mesh, of this rank's
    rows."""
    hidden, caches = backbone(params, tokens, cfg, mesh, with_cache=True)
    names = ("c", "kr") if cfg.mla is not None else ("k", "v")
    cache = {n: torch.stack([kv[i] for kv in caches])
             for i, n in enumerate(names)}
    return logits_fn(params, hidden[:, -1], cfg), cache
