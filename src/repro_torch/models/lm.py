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
each with the reference's ``mesh`` argument and, under a mesh, ``specs``:
the ``PartitionSpec`` of each param (``configs.lm_common``'s rules, the
reference's ``in_specs``), whose block under it is what ``params`` holds.
``mesh=None`` is the local path (the mesh fields of ``LMConfig`` have no
effect there, as in the reference). Under a ``distributed.mesh.Mesh`` each
``torch.distributed`` rank holds and computes its blocks, in the layout
the reference's specs give GSPMD:

- its rows of the batch (``cfg.batch_axes``: tokens, hidden states,
  logits), the activations between blocks replicated over ``model``;
- Megatron tensor parallelism over ``model``: the attention heads (GQA or
  MLA), the FFN and the vocab split, a column-parallel product's input
  through ``in_boundary`` and a row-parallel product's output summed by
  ``reduce_from``. GQA's k/v columns cut a kv head where the kv heads do
  not divide the axis, so a rank gathers the k/v weight columns (train,
  prefill) or the new token's q/k/v (decode) to whole heads before
  qk-norm and RoPE. MLA gathers its q and kv latents before their norms.
  The vocab-parallel embedding is a masked local lookup summed over
  ``model``; the logits stay vocab-sharded, and the loss takes its
  logsumexp and the target's logit across the vocab blocks;
- FSDP: a param whose spec also shards a dim over the batch axes (the
  ``fsdp`` rules) is gathered over them inside its checkpointed layer, so
  the gathered weights die with the layer and are gathered again in the
  backward, whose reduce-scatter is those axes' data-parallel sum;
- KV caches split on the sequence over ``model``: prefill returns each
  rank's sequence block, decode writes the slot on the rank that holds it
  and combines the ranks' partial attention (split-K,
  ``models.attention.decode_attention_split``);
- the MoE layers' expert parallelism where ``ep_axis`` is set
  (``moe_ffn_sharded``, or the 2D serving layout ``moe_ffn_2d`` with
  ``ep_2d`` and ``ep_token_chunk``) on the blocks their region's in_specs
  give;
- context-parallel attention where ``context_parallel`` is set, the
  attention is replicated over ``model`` (qwen2's rules) and T divides the
  axis (the rank's T block of queries against all keys);
- sequence sharding of the residual stream between layers with
  ``seq_shard`` (off with a cache, as in the reference).

Every rank's cotangent of a replicated activation is the whole one, so
after a backward a param's gradient block is the rank's rows' share, and a
sum over the batch axes its spec leaves out (``configs.lm_common``) gives
the reference's ``jax.grad`` block.

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
from repro_torch.distributed.mesh import (Mesh, all_gather, gather_blocks,
                                          in_boundary, out_boundary,
                                          own_block, psum, reduce_from,
                                          respec)
from repro_torch.distributed.shardings import P, mentioned
from repro_torch.embedding.layout import lookup
from repro_torch.embedding.sharded import (row_parallel_lookup,
                                           vocab_parallel_nll)
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (decode_attention,
                                          decode_attention_split,
                                          flash_attention, write_slot)
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


def _check_mesh(mesh, cfg: LMConfig, specs=None) -> None:
    """A mesh is None or a ``Mesh`` whose axes are ``cfg.batch_axes`` and
    ``model``, the layout's two kinds, with the params' ``specs``."""
    if mesh is None:
        return
    if specs is None:
        raise ValueError("under a mesh the LM needs the params' specs")
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a repro_torch.distributed.mesh.Mesh "
                        f"or None, not {type(mesh).__name__}")
    if sorted(mesh.axis_names) != sorted((*cfg.batch_axes, "model")):
        raise ValueError(f"the LM's layout needs a mesh of the batch axes "
                         f"{cfg.batch_axes} and 'model'; this one has "
                         f"{mesh.axis_names}")
    if cfg.context_parallel and any(
            _tp(s) for name in ("dense_layers", "moe_layers")
            if name in specs for s in tree.leaves(specs[name]["attn"])):
        raise ValueError("context-parallel attention needs the attention "
                         "replicated over 'model' (qwen2's rules); these "
                         "specs split it")


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


# ---------------------------------------------------------------- layout --
def _tp(spec) -> bool:
    """Whether a block is cut over ``model`` (Megatron TP)."""
    return spec is not None and "model" in mentioned(spec)


def _megatron(spec):
    """``spec`` with every entry but ``model``'s dropped: the block the
    dense parts compute on once the FSDP axes are gathered."""
    return P(*(e if e is not None and "model" in mentioned(P(e)) else None
               for e in spec))


def _layer_spec(specs):
    """One layer's specs of stacked specs (the leading ``L`` entry
    dropped)."""
    return tree.tree_map(lambda sp: P(*tuple(sp)[1:]), specs)


def _layer_blocks(p, s, cfg: LMConfig, mesh):
    """One layer's blocks as its computation takes them, and their specs:
    the FSDP axes gathered (``respec``), the MoE params at their region's
    in_specs (whole where the MoE runs locally)."""
    want = tree.tree_map(_megatron, s)
    if "moe" in p:
        want["moe"] = ((_moe_specs_2d(cfg) if cfg.ep_2d else _moe_specs(cfg))
                       if cfg.ep_axis is not None
                       else tree.tree_map(lambda _: P(), s["moe"]))
    return (tree.tree_map(lambda a, h, w: respec(a, mesh, h, w), p, s, want),
            want)


def _local_heads(cfg: LMConfig, n: int) -> tuple[int, int, int]:
    """Under TP over ``n`` ranks: the query heads a rank holds, the first
    of the kv heads they read (per rank index, times the returned step)
    and how many. A rank's heads must be whole and read whole kv groups,
    or lie in one."""
    h, rep = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
    hl = h // n
    if h % n or (hl % rep and rep % hl):
        raise ValueError(f"{cfg.name}: {h} heads in groups of {rep} do not "
                         f"split over {n} model ranks")
    return hl, rep, max(1, hl // rep)


def _seq_block(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of ``x`` along dim 1 over ``model`` (a cache's
    sequence)."""
    return respec(x, mesh, P(), P(None, "model"))


# --------------------------------------------------------------- forward --
def _rope(x, positions, theta: float, dh: int):
    cos, sin = rope_angles(positions, dh, theta, x.dtype)
    return apply_rope(x, cos[:, :, None], sin[:, :, None])


def _rope_qk(q, k, positions, cfg: LMConfig):
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta, q.dtype)
    return (apply_rope(q, cos[:, :, None], sin[:, :, None]),
            apply_rope(k, cos[:, :, None], sin[:, :, None]))


def _proj(x, w, bias):
    y = x @ w
    return y if bias is None else y + bias


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


def _gqa_tp(p, x, cfg: LMConfig, positions, mesh, with_cache: bool):
    """GQA with the heads over ``model``: the rank's query heads against
    the kv heads they read, whose columns it gathers whole from the
    ranks' k/v weight blocks (a block may cut a head, and qk-norm and
    RoPE's rotate-half need all of it). The output projection is
    row-parallel. With ``with_cache`` it also returns the rank's sequence
    block of every kv head for the cache."""
    b, t, _ = x.shape
    dh = cfg.head_dim
    hl, rep, nk = _local_heads(cfg, mesh.axis_size("model"))
    k0 = mesh.axis_index("model") * hl // rep
    w_k, w_v = (all_gather(p[w], mesh, "model", dim=1) for w in ("wk", "wv"))
    b_k, b_v = (all_gather(p[w], mesh, "model") if w in p else None
                for w in ("bk", "bv"))
    cols = slice(k0 * dh, (k0 + nk) * dh)
    xin = in_boundary(x, mesh, "model")
    q = _proj(xin, p["wq"], p.get("bq")).reshape(b, t, hl, dh)
    k = _proj(xin, w_k[:, cols], None if b_k is None else b_k[cols]) \
        .reshape(b, t, nk, dh)
    v = _proj(xin, w_v[:, cols], None if b_v is None else b_v[cols]) \
        .reshape(b, t, nk, dh)
    if cfg.qk_norm:
        q = rms_norm(q, in_boundary(p["q_norm"]["gamma"], mesh, "model"))
        k = rms_norm(k, in_boundary(p["k_norm"]["gamma"], mesh, "model"))
    q, k = _rope_qk(q, k, positions, cfg)
    out = flash_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk)
    attn = reduce_from(out.reshape(b, t, hl * dh) @ p["wo"], mesh, "model")
    if not with_cache:
        return attn, None
    xs, pos = _seq_block(x, mesh), _seq_block(positions, mesh)
    kc = _proj(xs, w_k, b_k).reshape(b, xs.shape[1], cfg.n_kv_heads, dh)
    vc = _proj(xs, w_v, b_v).reshape(b, xs.shape[1], cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        kc = rms_norm(kc, p["k_norm"]["gamma"])
    return attn, (_rope(kc, pos, cfg.rope_theta, dh), vc)


def _gqa_attention(p, x, cfg: LMConfig, positions, mesh=None, tp=False,
                   with_cache=False):
    """GQA over x (B,T,D): returns (out, the KV for the cache); under a
    mesh that KV is the rank's sequence block."""
    if tp:
        return _gqa_tp(p, x, cfg, positions, mesh, with_cache)
    b, t, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    if cfg.context_parallel and mesh is not None \
            and t % mesh.shape["model"] == 0:
        out = _cp_attention(q, k, v, cfg, mesh)
    else:
        out = flash_attention(q, k, v, causal=True,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    kv = (k, v)
    if mesh is not None and with_cache:
        kv = (_seq_block(k, mesh), _seq_block(v, mesh))
    return out.reshape(b, t, cfg.n_heads * cfg.head_dim) @ p["wo"], kv


def _dense_ffn(p, x, cfg: LMConfig, mesh=None, tp=False):
    """The dense FFN; with ``tp`` its F over ``model`` (the input
    column-parallel, the output row-parallel)."""
    if tp:
        x = in_boundary(x, mesh, "model")
    if cfg.act == "swiglu":
        y = (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    else:
        y = squared_relu(x @ p["w_in"]) @ p["w_out"]
    return reduce_from(y, mesh, "model") if tp else y


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
    ``ep_axis``, else ``p`` holds the rank's blocks by the region's specs
    (``_layer_blocks``), run through ``moe_ffn_2d`` (``ep_2d``) or
    ``moe_ffn_sharded`` on its rows ``x``. The ranks of ``model`` share the
    work: the cotangents of ``x`` and of the router (whole on each rank)
    are summed over it, and the output's divided by it, since all of them
    use it."""
    if cfg.ep_axis is None or mesh is None:
        return moe_lib.moe_ffn(p, x, cfg.moe)
    specs = _moe_specs_2d(cfg) if cfg.ep_2d else _moe_specs(cfg)
    p = tree.tree_map(lambda a, sp: a if _tp(sp)
                      else in_boundary(a, mesh, "model"), p, specs)
    x = in_boundary(x, mesh, "model")
    if cfg.ep_2d:
        y = moe_lib.moe_ffn_2d(p, x, cfg.moe, model_axis=cfg.ep_axis,
                               data_axis="data", batch_axes=cfg.batch_axes,
                               token_chunk=cfg.ep_token_chunk, mesh=mesh)
    else:
        y = moe_lib.moe_ffn_sharded(p, x, cfg.moe, axis_name=cfg.ep_axis,
                                    mesh=mesh)
    return out_boundary(y, mesh, P(cfg.batch_axes, None, None))


def _ffn(p, s, h, cfg: LMConfig, mesh):
    if "moe" in p:
        return _moe_block(p["moe"], h, cfg, mesh)
    tp = mesh is not None and _tp(s["ffn"]["w_down" if "w_down" in p["ffn"]
                                           else "w_out"])
    return _dense_ffn(p["ffn"], h, cfg, mesh, tp)


def _layer_fwd(p, x, cfg: LMConfig, positions, mesh=None, s=None,
               with_cache: bool = False):
    """One block; returns (x, its KV for the cache: under a mesh the
    rank's sequence block). Under a mesh ``p`` holds the layer's blocks
    under ``s``, gathered here over the FSDP axes."""
    if mesh is not None:
        p, s = _layer_blocks(p, s, cfg, mesh)
    if cfg.mla is not None:
        attn, kv = mla_lib.mla_attention(
            p["attn"], rms_norm(x, p["ln1"]["gamma"]), cfg.mla, positions,
            mesh=mesh)
        if mesh is not None and with_cache:
            kv = (_seq_block(kv[0], mesh), _seq_block(kv[1], mesh))
    else:
        attn, kv = _gqa_attention(
            p["attn"], rms_norm(x, p["ln1"]["gamma"]), cfg, positions, mesh,
            mesh is not None and _tp(s["attn"]["wq"]), with_cache)
    x = x + attn
    return x + _ffn(p, s, rms_norm(x, p["ln2"]["gamma"]), cfg, mesh), kv


def _layer(stacked, i: int):
    return tree.tree_map(lambda a: a[i], stacked)


def _scan_layers(stacked, x, cfg: LMConfig, positions, mesh=None,
                 with_cache: bool = False, specs=None):
    """The layers of ``stacked`` in order over x; returns (x, [KV per
    layer]) with ``with_cache``, else (x, None).

    With ``seq_shard`` under a mesh (``repro/models/lm.py:281-314``; not
    with a cache) each rank keeps its (B, T / n_model, D) block of the
    residual stream between layers, so that a checkpoint holds that block
    only, and gathers it over ``model`` at each layer's input."""
    n_layers = tree.leaves(stacked)[0].shape[0]
    remat = torch.is_grad_enabled() and not with_cache
    sp = cfg.seq_shard and mesh is not None and not with_cache
    s = None if specs is None else _layer_spec(specs)

    def body(carry, i):
        if sp:
            carry = gather_blocks(carry, mesh, "model", 1)
        y, _ = _layer_fwd(_layer(stacked, i), carry, cfg, positions, mesh, s)
        return own_block(y, mesh, "model", 1) if sp else y

    def step(carry, i):
        if remat and cfg.remat:
            return checkpoint(body, carry, i, use_reentrant=False)
        return body(carry, i)

    if with_cache:
        kvs = []
        for i in range(n_layers):
            x, kv = _layer_fwd(_layer(stacked, i), x, cfg, positions, mesh,
                               s, with_cache=True)
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


def _embed(params, tokens, mesh=None, specs=None):
    """The embedding rows of ``tokens``. Under a mesh the vocab is split
    over ``model``: each rank looks up the ids in its block (the global id
    clamped first, the port's contract, then masked to the block) and the
    rows are summed over ``model``."""
    if mesh is None:
        return lookup(params["embed"], tokens)
    s = specs["embed"]
    table = respec(params["embed"], mesh, s, _megatron(s))
    if not _tp(s):
        return lookup(table, tokens)
    return row_parallel_lookup(table, tokens, mesh)


def _head(params, mesh, specs):
    """(the head's block (D, V / n) over the vocab, FSDP axes gathered;
    whether the vocab is split over more than one ``model`` rank)."""
    name = "embed" if "head" not in params else "head"
    s = specs[name]
    w = respec(params[name], mesh, s, _megatron(s))
    return ((w.T if name == "embed" else w),
            _tp(s) and mesh.axis_size("model") > 1)


def backbone(params, tokens, cfg: LMConfig, mesh=None, positions=None,
             with_cache: bool = False, specs=None):
    """tokens (B,T) -> final hidden (B,T,D) [+ the KV of every layer].
    Under a mesh, ``tokens`` are this rank's rows and ``params`` its blocks
    under ``specs`` (module docstring)."""
    _check_mesh(mesh, cfg, specs)
    b, t = tokens.shape
    if positions is None:
        positions = _positions(b, t, tokens.device)
    x = _embed(params, tokens, mesh, specs)
    caches = []
    for name in ("dense_layers", "moe_layers"):
        if name in params:
            x, kv = _scan_layers(params[name], x, cfg, positions, mesh,
                                 with_cache,
                                 None if specs is None else specs[name])
            caches.extend(kv or [])
    x = rms_norm(x, params["final_norm"]["gamma"])
    return (x, caches) if with_cache else x


def logits_fn(params, hidden, cfg: LMConfig, mesh=None, specs=None):
    """hidden (..., D) -> logits (..., V); under a mesh the rank's vocab
    block (..., V / n) where the head splits the vocab over ``model``."""
    if mesh is None:
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        return hidden @ head
    head, tp = _head(params, mesh, specs)
    return (in_boundary(hidden, mesh, "model") if tp else hidden) @ head


def _ce_sum(params, cfg: LMConfig, h, tgt, w):
    """One chunk's weighted NLL sum (the params, not the head, go through
    the checkpoint, so that it saves no vocab-sized tensor)."""
    return _nll_sum(logits_fn(params, h, cfg), tgt, w)


def _nll_sum(logits, tgt, w):
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return (nll * w).sum()


def _ce_sum_whole(head, h, tgt, w):
    """``_ce_sum`` under a mesh whose ``model`` axis does not split the
    vocab (the head's FSDP axes gathered)."""
    return _nll_sum(h @ head, tgt, w)


def _ce_sum_sharded(head, mesh, h, tgt, w):
    """``_ce_sum`` with the head's vocab split over ``model``: the
    logsumexp and the target's logit across the ranks' vocab blocks (a
    max, a sum and the target's logit summed over ``model``; the target
    clamped into the vocab as an id is)."""
    logits = (in_boundary(h, mesh, "model") @ head).float()
    return (vocab_parallel_nll(logits, tgt, mesh) * w).sum()


def chunked_ce(params, hidden, targets, cfg: LMConfig, t_chunk: int = 512,
               weights=None):
    """Mean token NLL with seq-chunked logits (memory-efficient CE).

    ``hidden`` (B,T,D), ``targets`` (B,T). T is padded up to a multiple of
    ``t_chunk`` (padded positions weigh 0), and the (B, t_chunk, V) logits
    block is the only vocab-sized tensor alive at once: each chunk is
    checkpointed, so the backward recomputes it instead of keeping (B, T,
    V) logits.
    """
    acc, total = _ce_terms(_ce_sum, (params, cfg), hidden, targets, t_chunk,
                           weights)
    return acc / total.clamp_min(1.0)


def _ce_terms(ce_sum, args, hidden, targets, t_chunk: int = 512,
              weights=None):
    """``chunked_ce``'s weighted NLL sum and its weights' sum, each chunk's
    sum ``ce_sum(*args, h, targets, weights)``."""
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
        chunk = (*args, hidden[:, lo:lo + t_chunk],
                 targets[:, lo:lo + t_chunk], weights[:, lo:lo + t_chunk])
        acc = acc + (checkpoint(ce_sum, *chunk, use_reentrant=False)
                     if torch.is_grad_enabled() else ce_sum(*chunk))
    return acc, weights.sum()


def _mean_nll(params, hidden, targets, cfg: LMConfig, mesh, specs):
    """``chunked_ce`` over the whole batch: under a mesh, each rank's rows
    over every rank's weight, summed over the batch axes, with the vocab
    split over ``model`` where the head splits it. The sum's cotangent is
    divided over the batch axes (``out_boundary``), so that each rank's
    backward is its own rows' share of the mean."""
    if mesh is None:
        return chunked_ce(params, hidden, targets, cfg)
    head, tp = _head(params, mesh, specs)
    acc, total = (_ce_terms(_ce_sum_sharded, (head, mesh), hidden, targets)
                  if tp else _ce_terms(_ce_sum_whole, (head,), hidden,
                                       targets))
    share = acc / psum(total, mesh, cfg.batch_axes).clamp_min(1.0)
    return out_boundary(psum(share, mesh, cfg.batch_axes), mesh, P("model"))


def _mtp_proj(params, x, mesh, specs):
    """MTP's (2D, D) projection of x; under a mesh column-parallel over
    ``model`` where its spec splits it, the rank's output columns rejoined
    over ``model``."""
    w = params["mtp"]["proj"]
    if mesh is None:
        return x @ w
    s = specs["mtp"]["proj"]
    w = respec(w, mesh, s, _megatron(s))
    if not _tp(s):
        return x @ w
    return gather_blocks(in_boundary(x, mesh, "model") @ w, mesh, "model",
                         -1)


def train_loss(params, batch, cfg: LMConfig, mesh=None, specs=None):
    """batch: {tokens (B,T), targets (B,T)}; mean next-token CE (+ MTP).

    Under a mesh ``batch`` holds this rank's rows and ``params`` its blocks
    under ``specs``; the loss is the whole batch's mean on every rank, and
    its gradient the rank's share (module docstring)."""
    tokens, targets = batch["tokens"], batch["targets"]
    hidden = backbone(params, tokens, cfg, mesh, specs=specs)
    loss = _mean_nll(params, hidden, targets, cfg, mesh, specs)
    if cfg.mtp and "mtp" in params:
        # predict t+2: combine h_t with emb(t+1), one extra block.
        emb_next = _embed(params, tokens, mesh, specs)
        h = _mtp_proj(params, torch.cat([hidden[:, :-1], emb_next[:, 1:]],
                                        -1), mesh, specs)
        h = rms_norm(h, params["mtp"]["norm"]["gamma"])
        b, tm1, _ = h.shape
        h, _ = _layer_fwd(params["mtp"]["layer"], h, cfg,
                          _positions(b, tm1, h.device), mesh,
                          None if specs is None else specs["mtp"]["layer"])
        # position i of h fuses hidden_i with emb(token_{i+1}) and predicts
        # token_{i+2} = targets[i+1], for i in [0, T-2].
        loss = loss + cfg.mtp_weight * _mean_nll(
            params, h, targets[:, 1:], cfg, mesh, specs)
    return loss


# ---------------------------------------------------------------- decode --
def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device: str | torch.device = "cuda", mesh=None) -> dict:
    """Zero caches of ``batch`` rows and ``max_len`` slots; under a mesh
    this rank's block of them (its rows over ``cfg.batch_axes``, its
    sequence block over ``model``)."""
    dev = resolve_device(device)
    if mesh is not None:
        nb, ns = mesh.axis_size(cfg.batch_axes), mesh.axis_size("model")
        if batch % nb or max_len % ns:
            raise ValueError(f"a cache of {batch} x {max_len} does not "
                             f"split over {nb} x {ns} ranks")
        batch, max_len = batch // nb, max_len // ns
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


def _gqa_decode_split(p, h, cache, length, cfg: LMConfig, mesh, tp: bool):
    """One token's GQA over a cache whose sequence is split over
    ``model``: every rank needs the token's q, k and v of every head (it
    attends over its slots for all of them), so under TP the rank's
    column blocks are gathered to whole heads; the slot's owner writes it,
    the ranks' partial attention is combined (split-K), and under TP each
    rank keeps its heads for the row-parallel output projection."""
    b = h.shape[0]
    dh, n = cfg.head_dim, mesh.axis_size("model")
    pos = torch.full((b, 1), int(length), dtype=torch.int32, device=h.device)
    if tp:
        hl = _local_heads(cfg, n)[0]
        q = _proj(h, p["wq"], p.get("bq")).reshape(b, 1, hl, dh)
        k, v = (gather_blocks(_proj(h, p[w], p.get(bb)), mesh, "model", -1)
                .reshape(b, 1, cfg.n_kv_heads, dh)
                for w, bb in (("wk", "bk"), ("wv", "bv")))
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"]["gamma"])
            k = rms_norm(k, p["k_norm"]["gamma"])
        q, k = _rope_qk(q, k, pos, cfg)
        q = gather_blocks(q, mesh, "model", 2)
    else:
        q, k, v = _qkv(p, h, cfg)
        q, k = _rope_qk(q, k, pos, cfg)
    s_loc = cache["k"].shape[1]
    start = mesh.axis_index("model") * s_loc
    write_slot(cache["k"], k, length, s_loc * n, start)
    write_slot(cache["v"], v, length, s_loc * n, start)
    out = decode_attention_split(q[:, 0], cache["k"], cache["v"],
                                 int(length) + 1, mesh)
    if not tp:
        return out.reshape(b, 1, cfg.n_heads * dh) @ p["wo"]
    out = own_block(out, mesh, "model", 1)
    return reduce_from(out.reshape(b, 1, -1) @ p["wo"], mesh, "model")


def _decode_layer(p, x, cache_slice, length, cfg: LMConfig, mesh=None,
                  s=None):
    """x (B,1,D) one layer; writes the token's KV into ``cache_slice`` (one
    layer's cache; under a mesh the rank's block) in place and returns
    x."""
    if mesh is not None:
        p, s = _layer_blocks(p, s, cfg, mesh)
    b = x.shape[0]
    h = rms_norm(x, p["ln1"]["gamma"])
    if cfg.mla is not None:
        attn, _, _ = mla_lib.mla_decode(p["attn"], h, cache_slice["c"],
                                        cache_slice["kr"], length, cfg.mla,
                                        mesh=mesh)
    elif mesh is not None:
        attn = _gqa_decode_split(p["attn"], h, cache_slice, length, cfg,
                                 mesh, _tp(s["attn"]["wq"]))
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
    return x + _ffn(p, s, rms_norm(x, p["ln2"]["gamma"]), cfg, mesh)


def decode_step(params, cache, tokens, length, cfg: LMConfig, mesh=None,
                specs=None):
    """One serve step: tokens (B,) int, ``length`` (an int) tokens already
    cached.

    Returns (logits (B,V), cache). The cache is updated in place (the
    reference's serve step donates it) and returned. The token's KV goes
    into slot ``length``; at or past the cache's end it overwrites the
    last slot, with RoPE still at position ``length``, and the step
    returns finite logits: the reference's ``dynamic_update_slice`` clamps
    its index the same way, so the two agree there too.

    Under a mesh ``tokens`` hold this rank's batch rows, the cache its
    block of them and of the sequence (the plans' cache specs), ``params``
    its blocks under ``specs``; the logits are the rank's rows of its
    vocab block.
    """
    _check_mesh(mesh, cfg, specs)
    x = _embed(params, tokens[:, None], mesh, specs)
    offset = 0
    for name in ("dense_layers", "moe_layers"):
        if name not in params:
            continue
        stacked = params[name]
        s = None if specs is None else _layer_spec(specs[name])
        for i in range(tree.leaves(stacked)[0].shape[0]):
            layer_cache = {k: c[offset + i] for k, c in cache.items()}
            x = _decode_layer(_layer(stacked, i), x, layer_cache, length,
                              cfg, mesh, s)
        offset += tree.leaves(stacked)[0].shape[0]
    x = rms_norm(x, params["final_norm"]["gamma"])
    return logits_fn(params, x[:, 0], cfg, mesh, specs), cache


def prefill(params, tokens, cfg: LMConfig, mesh=None, specs=None):
    """tokens (B,T) -> (last-position logits (B,V), stacked caches of
    exactly T slots in the compute dtype); under a mesh, of this rank's
    rows, its vocab block of the logits and its sequence block of the
    caches."""
    hidden, caches = backbone(params, tokens, cfg, mesh, with_cache=True,
                              specs=specs)
    names = ("c", "kr") if cfg.mla is not None else ("k", "v")
    cache = {n: torch.stack([kv[i] for kv in caches])
             for i, n in enumerate(names)}
    return logits_fn(params, hidden[:, -1], cfg, mesh, specs), cache
