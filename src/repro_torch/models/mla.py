"""Multi-head Latent Attention (DeepSeek-V2/V3) on torch tensors. Port of
``repro.models.mla``.

Queries come from a low-rank path (w_dq -> RMS -> w_uq); keys/values are
decompressed from a shared 512-d latent ``c_kv``; a separate small RoPE key
(64-d, shared across heads) carries position. Train/prefill decompress K/V
and run flash attention (the default chunks 512/1024, not the LM's).
Decode uses the **absorption trick**: scores are computed directly in
latent space (q_nope absorbed through W_uk, context re-expanded through
W_uv), so the KV cache is just ``(c_kv: kv_lora_rank, k_rope: rope_dim)``
per token. Its mask is ``slot <= length`` (the new token's slot included).

Under a mesh (``mesh`` given) the projections are Megatron blocks over
``model`` (``configs.lm_common.lm_param_rules``): ``w_dq``, ``w_uq``,
``w_dkv`` and ``w_ukv`` column blocks, so a rank holds its heads, ``w_o``
a row block summed over ``model``, ``w_kr`` and the norms whole. ``w_dq``
and ``w_dkv`` cut the latents their RMS norms read whole, so each latent
is gathered over ``model`` before its norm. Decode's cache is the rank's
block of the sequence: the scores of every head over it (each rank's
absorbed queries gathered), the softmax and the latent context combined
over ``model`` (split-K), and the rank's heads kept for ``w_uv`` and
``w_o``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.mesh import (gather_blocks, in_boundary,
                                          own_block, reduce_from)
from repro_torch.models.attention import (flash_attention, split_softmax,
                                          write_slot)
from repro_torch.models.common import (apply_rope, normal_init, rms_init,
                                       rms_norm, rope_angles)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_head_dim(self) -> int:
        return self.nope_head_dim + self.rope_head_dim


def init_mla(gen: torch.Generator, cfg: MLAConfig,
             dtype=torch.float32) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    s = d ** -0.5
    return {
        "w_dq": normal_init(gen, (d, cfg.q_lora_rank), s, dtype),
        "q_norm": rms_init(cfg.q_lora_rank, dtype, gen.device),
        "w_uq": normal_init(gen, (cfg.q_lora_rank, h * cfg.qk_head_dim),
                            cfg.q_lora_rank ** -0.5, dtype),
        "w_dkv": normal_init(gen, (d, cfg.kv_lora_rank), s, dtype),
        "kv_norm": rms_init(cfg.kv_lora_rank, dtype, gen.device),
        "w_ukv": normal_init(
            gen, (cfg.kv_lora_rank,
                  h * (cfg.nope_head_dim + cfg.v_head_dim)),
            cfg.kv_lora_rank ** -0.5, dtype),
        "w_kr": normal_init(gen, (d, cfg.rope_head_dim), s, dtype),
        "w_o": normal_init(gen, (h * cfg.v_head_dim, d),
                           (h * cfg.v_head_dim) ** -0.5, dtype),
    }


def _local_heads(params, cfg: MLAConfig, mesh) -> int:
    """The heads this rank's blocks hold: ``n_heads`` over the ``model``
    ranks, or it raises (MLA on a mesh takes the Megatron blocks)."""
    hl = params["w_uq"].shape[1] // cfg.qk_head_dim
    if hl * mesh.axis_size("model") != cfg.n_heads:
        raise ValueError(f"MLA on a mesh takes its heads' blocks over "
                         f"'model': {hl} of {cfg.n_heads} heads on "
                         f"{mesh.axis_size('model')} ranks")
    return hl


def _project_qkv(params, x, cfg: MLAConfig, positions, mesh=None):
    """Shared projections. x (B,T,D) -> q_nope, q_rope (B,T,H,.), latent c
    (B,T,R), k_rope (B,T,1,rope); under a mesh q holds the rank's heads
    and the latents are whole."""
    b, t, _ = x.shape
    h = cfg.n_heads
    if mesh is None:
        q = rms_norm(x @ params["w_dq"], params["q_norm"]["gamma"])
        q = (q @ params["w_uq"]).reshape(b, t, h, cfg.qk_head_dim)
        c_kv = rms_norm(x @ params["w_dkv"], params["kv_norm"]["gamma"])
    else:
        h = _local_heads(params, cfg, mesh)
        xin = in_boundary(x, mesh, "model")
        q = rms_norm(gather_blocks(xin @ params["w_dq"], mesh, "model", -1),
                     params["q_norm"]["gamma"])
        q = (in_boundary(q, mesh, "model") @ params["w_uq"]).reshape(
            b, t, h, cfg.qk_head_dim)
        c_kv = rms_norm(gather_blocks(xin @ params["w_dkv"], mesh, "model",
                                      -1), params["kv_norm"]["gamma"])
    q_nope, q_rope = q.split([cfg.nope_head_dim, cfg.rope_head_dim], -1)
    k_rope = (x @ params["w_kr"])[:, :, None, :]
    cos, sin = rope_angles(positions, cfg.rope_head_dim, cfg.rope_theta,
                           x.dtype)
    q_rope = apply_rope(q_rope, cos[:, :, None], sin[:, :, None])
    k_rope = apply_rope(k_rope, cos[:, :, None], sin[:, :, None])
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(params, x, cfg: MLAConfig, positions=None, mesh=None):
    """Full (train/prefill) MLA. x (B,T,D) -> (B,T,D), plus decode cache
    ``(c_kv (B,T,R), k_rope (B,T,rope))``; under a mesh each rank attends
    with its heads and the output is summed over ``model``."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _project_qkv(params, x, cfg, positions,
                                                mesh)
    h = q_nope.shape[2]
    c_in, kr_in = c_kv, k_rope
    if mesh is not None:
        c_in, kr_in = (in_boundary(a, mesh, "model") for a in (c_kv, k_rope))
    kv = (c_in @ params["w_ukv"]).reshape(
        b, t, h, cfg.nope_head_dim + cfg.v_head_dim)
    k_nope, v = kv.split([cfg.nope_head_dim, cfg.v_head_dim], -1)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, kr_in.expand(b, t, h, cfg.rope_head_dim)], -1)
    out = flash_attention(q, k, v, causal=True,
                          scale=cfg.qk_head_dim ** -0.5)
    out = out.reshape(b, t, h * cfg.v_head_dim) @ params["w_o"]
    if mesh is not None:
        out = reduce_from(out, mesh, "model")
    return out, (c_kv, k_rope[:, :, 0, :])


def mla_decode(params, x, cache_c, cache_kr, length, cfg: MLAConfig,
               mesh=None):
    """Absorbed single-token decode.

    x (B,1,D); cache_c (B,S,R); cache_kr (B,S,rope); ``length`` = current
    position. The new token's latent is written into the caches in place
    (``write_slot``: at ``length``, clamped to the last slot). Returns
    (out (B,1,D), the caches). Under a mesh the caches are the rank's
    sequence block (module docstring).
    """
    b = x.shape[0]
    h = cfg.n_heads
    pos = torch.full((b, 1), int(length), dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, kr_new = _project_qkv(params, x, cfg, pos, mesh)
    s = cache_c.shape[1]
    start, n_slots = 0, s
    if mesh is not None:
        n_slots = s * mesh.axis_size("model")
        start = mesh.axis_index("model") * s
    write_slot(cache_c, c_new, length, n_slots, start)
    write_slot(cache_kr, kr_new[:, :, 0, :], length, n_slots, start)

    # a cache in another dtype than x promotes, as JAX promotes
    dt = torch.promote_types(x.dtype, cache_c.dtype)
    c, kr = cache_c.to(dt), cache_kr.to(dt)
    hl = q_nope.shape[2]
    w_ukv = params["w_ukv"].to(dt).reshape(
        cfg.kv_lora_rank, hl, cfg.nope_head_dim + cfg.v_head_dim)
    w_uk = w_ukv[:, :, :cfg.nope_head_dim]              # (R,H,nope)
    w_uv = w_ukv[:, :, cfg.nope_head_dim:]              # (R,H,v)
    # absorb: q_abs (B,H,R)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(dt), w_uk)
    q_r = q_rope[:, 0].to(dt)
    if mesh is not None:          # every head's scores over the rank's slots
        q_abs = gather_blocks(q_abs, mesh, "model", 1)
        q_r = gather_blocks(q_r, mesh, "model", 1)
    logits = torch.einsum("bhr,bsr->bhs", q_abs, c)
    logits = logits + torch.einsum("bhd,bsd->bhs", q_r, kr)
    logits = logits * (cfg.qk_head_dim ** -0.5)
    valid = start + torch.arange(s, device=x.device)[None, None, :] \
        <= int(length)
    if mesh is None:
        w = torch.softmax(torch.where(valid, logits.float(), -1e30),
                          -1).to(x.dtype)
        ctx = torch.einsum("bhs,bsr->bhr", w.to(dt), c)     # latent context
    else:
        w = split_softmax(logits, valid, mesh, "model", x.dtype)
        ctx = reduce_from(torch.einsum("bhs,bsr->bhr", w.to(dt), c), mesh,
                          "model")
        ctx = own_block(ctx, mesh, "model", 1)
    out = torch.einsum("bhr,rhd->bhd", ctx, w_uv)       # (B,H,v)
    out = out.reshape(b, 1, hl * cfg.v_head_dim) @ params["w_o"].to(dt)
    if mesh is not None:
        out = reduce_from(out, mesh, "model")
    return out, cache_c, cache_kr
