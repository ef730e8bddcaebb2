"""Mixture-of-Experts FFN: top-k routing + GShard blocked dispatch, on torch
tensors. Port of ``repro.models.moe``.

Dispatch is sort-based: token-expert assignments are sorted by expert id
(a stable sort, as ``jnp.argsort``), scattered into per-expert capacity
slots (E, C, D), and fed through block-diagonal batched GEMMs, the GShard
formulation. Overflowing assignments beyond an expert's capacity are
dropped: which ones is the reference's to the token. The capacity
``_cap_per_expert`` depends on the number of tokens in the call, so a
prefill of T - 1 tokens can clip other assignments than a forward of T.

The router runs in float32 on float32 weights, whatever the model's dtype.
Top-k breaks ties toward the lower expert index (``lax.top_k``'s rule).
The scatter-adds (``.at[].add``) are ``index_put_(accumulate=True)``; on
CUDA the combine adds a token's k expert outputs in no fixed order, so the
card agrees with the CPU to a tolerance, not bit for bit.

The mesh variants are the reference's ``shard_map`` bodies, run once per
``torch.distributed`` rank on its blocks (``distributed.mesh``):
``moe_ffn_sharded`` (replicated-activation expert parallelism, one psum
over the expert axis) and ``moe_ffn_2d`` (the weight-stationary serving
layout: the tokens gathered over the batch axes, one psum over ``(data,
model)``). Each routes every token it sees, keeps the assignments of its
own experts, and sizes their capacity by the tokens of its own call, so a
mesh drops other assignments than one device does over the whole batch,
exactly the reference's at each mesh coordinate.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import all_gather, psum
from repro_torch.models.common import dense_init, normal_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_expert: int
    n_experts: int
    top_k: int
    n_shared: int = 0           # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.5
    norm_topk: bool = True      # renormalise top-k probs (Qwen3)
    router_bias: bool = False   # aux-loss-free bias (DeepSeek) — inference
    act: str = "swiglu"


def init_moe(gen: torch.Generator, cfg: MoEConfig,
             dtype=torch.float32) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
    p = {
        "router": normal_init(gen, (d, e), d ** -0.5, torch.float32),
        "w_gate": normal_init(gen, (e, d, f), d ** -0.5, dtype),
        "w_up": normal_init(gen, (e, d, f), d ** -0.5, dtype),
        "w_down": normal_init(gen, (e, f, d), f ** -0.5, dtype),
    }
    if cfg.router_bias:
        p["router_b"] = torch.zeros((e,), dtype=torch.float32,
                                    device=gen.device)
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared"] = {
            "w_gate": dense_init(gen, d, fs, dtype),
            "w_up": dense_init(gen, d, fs, dtype),
            "w_down": dense_init(gen, fs, d, dtype),
        }
    return p


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties toward the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, x2d, cfg: MoEConfig):
    """x2d (T, D) -> top-k (probs (T,k) f32, experts (T,k) int64)."""
    logits = x2d.float() @ params["router"]
    scores = torch.softmax(logits, dim=-1)
    sel = scores + params["router_b"] if "router_b" in params else scores
    top_p, top_e = top_k(sel, cfg.top_k)
    if "router_b" in params:   # bias picks experts; gate uses unbiased probs
        top_p = torch.gather(scores, -1, top_e)
    if cfg.norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_p, top_e


def _blocked_ffn(xb, w_gate, w_up, w_down, act: str):
    """Block-diagonal expert FFN: xb (E, C, D) -> (E, C, D), one batched
    GEMM per projection (the reference's ``ecd,edf->ecf`` einsums)."""
    g = torch.bmm(xb, w_gate)
    u = torch.bmm(xb, w_up)
    if act == "swiglu":
        h = F.silu(g) * u
    elif act == "squared_relu":
        r = torch.relu(g + u)    # non-gated: fold both projections
        h = r * r
    else:
        raise ValueError(act)
    return torch.bmm(h, w_down)


def _slots(le, valid, e_local: int, cap_e: int):
    """The capacity slots of flat assignments: ``(order, le_s, slot_c,
    ok)``, assignment ``order[i]`` going to slot ``slot_c[i]`` of expert
    ``le_s[i]`` where ``ok[i]``, and dropped elsewhere. Assignments are
    sorted by expert (stable, so each expert keeps its first ``cap_e`` in
    flat order); invalid rows sink to the tail."""
    n = le.shape[0]
    order = torch.argsort(torch.where(valid, le, e_local), stable=True)
    v_s = valid[order]
    le_s = torch.where(v_s, le[order], e_local - 1)
    # a scatter-add, not bincount: its length is fixed by e_local, so the
    # dry-run (launch.dryrun) runs it on meta tensors too
    key = torch.where(v_s, le_s, e_local).long()
    group_sizes = torch.zeros(e_local + 1, dtype=torch.int64,
                              device=le.device).scatter_add_(
        0, key, torch.ones_like(key))[:e_local]
    start = torch.cumsum(group_sizes, 0) - group_sizes
    slot = torch.arange(n, device=le.device) - start[le_s]
    ok = v_s & (slot >= 0) & (slot < cap_e)
    return order, le_s, slot.clamp(0, cap_e - 1), ok


def _gshard_ffn(params, x2d, tok, le, probs, valid, e_local, cap_e,
                act: str):
    """Dispatch assignments into per-expert capacity slots, run the blocked
    FFN, and combine back to tokens.

    ``tok``/``le``/``probs``/``valid`` are flat assignment arrays (N,); rows
    with ``valid=False`` or overflowing an expert's ``cap_e`` slots are
    dropped (GShard capacity clipping). Returns (T, D) combined output.
    """
    d = x2d.shape[1]
    order, le_s, slot_c, ok = _slots(le, valid, e_local, cap_e)
    tok_s, p_s = tok[order], probs[order]
    rows = x2d[tok_s] * ok[:, None]
    xb = torch.zeros((e_local, cap_e, d), dtype=x2d.dtype,
                     device=x2d.device).index_put((le_s, slot_c), rows,
                                                  accumulate=True)
    out_b = _blocked_ffn(xb, params["w_gate"], params["w_up"],
                         params["w_down"], act)
    out_rows = out_b[le_s, slot_c] * (p_s.to(out_b.dtype) * ok)[:, None]
    return torch.zeros((x2d.shape[0], d), dtype=out_b.dtype,
                       device=x2d.device).index_put((tok_s,), out_rows,
                                                    accumulate=True)


def _shared_ffn(p, x):
    h = F.silu(x @ p["w_gate"]["w"]) * (x @ p["w_up"]["w"])
    return h @ p["w_down"]["w"]


def _cap_per_expert(cfg: MoEConfig, tokens: int) -> int:
    return max(4, int(cfg.capacity_factor * tokens * cfg.top_k
                      / cfg.n_experts))


def moe_ffn(params, x, cfg: MoEConfig):
    """Single-shard (or fully replicated experts) MoE FFN. x (..., D): every
    expert is local (shard 0 of one)."""
    shape = x.shape
    x2d = x.reshape(-1, cfg.d_model)
    y = _gshard_ffn(params, x2d, *_local_assignments(params, x2d, cfg, 0),
                    cfg.n_experts, _cap_per_expert(cfg, x2d.shape[0]),
                    cfg.act)
    if cfg.n_shared:
        y = y + _shared_ffn(params["shared"], x2d)
    return y.to(x.dtype).reshape(shape)


def _local_assignments(params, x2d, cfg: MoEConfig, shard: int):
    """Route every row of x2d (T, D) and keep the assignments of the
    ``e_local`` experts this shard holds (global ids ``shard * e_local``
    onward): ``_gshard_ffn``'s (tokens, local expert ids, probs, kept),
    each (T*k,)."""
    e_local = params["w_gate"].shape[0]
    top_p, top_e = _route(params, x2d, cfg)
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(x2d.shape[0], device=x2d.device) \
        .repeat_interleave(cfg.top_k)
    return (flat_t, flat_e % e_local, top_p.reshape(-1),
            (flat_e // e_local) == shard)


def moe_ffn_sharded(params, x, cfg: MoEConfig, axis_name: str = "model", *,
                    mesh):
    """Replicated-activation EP (``repro/models/moe.py:160-188``): the body
    of a ``shard_map`` over ``axis_name``, on this rank's blocks.

    ``params['w_gate'|'w_up'|'w_down']`` hold the rank's (E_local, ...)
    expert slice and the shared expert its slice of d_ff; the router is
    whole. ``x`` (..., D) is the same on every rank along ``axis_name``.
    Each rank runs its own experts on the assignments they own, at the
    capacity of its own ``T`` tokens, and one psum over ``axis_name``
    completes the combine (the shared expert's partial product too).
    """
    shape = x.shape
    x2d = x.reshape(-1, cfg.d_model)
    y = _gshard_ffn(params, x2d, *_local_assignments(
        params, x2d, cfg, mesh.axis_index(axis_name)),
        params["w_gate"].shape[0], _cap_per_expert(cfg, x2d.shape[0]),
        cfg.act)
    if cfg.n_shared:
        y = y + _shared_ffn(params["shared"], x2d)
    return psum(y, mesh, axis_name).to(x.dtype).reshape(shape)


def moe_ffn_2d(params, x, cfg: MoEConfig, model_axis: str = "model",
               data_axis: str = "data", batch_axes=("data",),
               token_chunk: int | None = None, *, mesh):
    """Weight-stationary 2D expert sharding for serving
    (``repro/models/moe.py:191-234``): the body of a ``shard_map`` on this
    rank's blocks, experts over ``model_axis`` and each expert's F over
    ``data_axis`` (the shared expert's F over both).

    The rank's (rows, D) block is gathered over ``batch_axes`` (batch
    major), every rank routes all of it, runs its (E_local, D, F_local)
    experts, and one psum over ``(data_axis, model_axis)`` completes both
    the F partial sums and the combine; the rank keeps its own rows.
    ``token_chunk`` runs the rows in chunks of that many (a loop, the
    reference's scan) when there are more rows and they divide: each
    chunk gathers ``token_chunk`` x the batch shards, and that is its
    capacity's token count.
    """
    shape = x.shape
    x2d = x.reshape(-1, cfg.d_model)
    rows = x2d.shape[0]
    args = (params, cfg, model_axis, data_axis, batch_axes, mesh)
    if token_chunk and rows > token_chunk and rows % token_chunk == 0:
        return torch.cat([_moe_2d_block(x2d[lo:lo + token_chunk], *args)
                          for lo in range(0, rows, token_chunk)]
                         ).reshape(shape)
    return _moe_2d_block(x2d, *args).reshape(shape)


def _moe_2d_block(x2d, params, cfg: MoEConfig, model_axis, data_axis,
                  batch_axes, mesh):
    """One chunk of ``moe_ffn_2d`` (``repro/models/moe.py:237-259``)."""
    rows = x2d.shape[0]
    x_full = all_gather(x2d, mesh, batch_axes)
    y = _gshard_ffn(params, x_full, *_local_assignments(
        params, x_full, cfg, mesh.axis_index(model_axis)),
        params["w_gate"].shape[0], _cap_per_expert(cfg, x_full.shape[0]),
        cfg.act)
    if cfg.n_shared:
        y = y + _shared_ffn(params["shared"], x_full)
    y = psum(y, mesh, (data_axis, model_axis)).to(x2d.dtype)
    lo = mesh.axis_index(batch_axes) * rows    # batch-major gather order
    return y[lo:lo + rows]


def load_balance_loss(params, x2d, cfg: MoEConfig):
    """Switch-style aux loss: E * sum_e f_e * p_e (f = fraction routed)."""
    logits = x2d.float() @ params["router"]
    probs = torch.softmax(logits, -1)
    _, top_e = top_k(probs, cfg.top_k)
    f = F.one_hot(top_e, cfg.n_experts).sum(-2).float().mean(0)
    p = probs.mean(0)
    return cfg.n_experts * torch.sum(f * p / cfg.top_k)
