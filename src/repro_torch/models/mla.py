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
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.attention import flash_attention, write_slot
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


def _project_qkv(params, x, cfg: MLAConfig, positions):
    """Shared projections. x (B,T,D) -> q_nope, q_rope (B,T,H,.), latent c
    (B,T,R), k_rope (B,T,1,rope)."""
    b, t, _ = x.shape
    h = cfg.n_heads
    q = rms_norm(x @ params["w_dq"], params["q_norm"]["gamma"])
    q = (q @ params["w_uq"]).reshape(b, t, h, cfg.qk_head_dim)
    q_nope, q_rope = q.split([cfg.nope_head_dim, cfg.rope_head_dim], -1)
    c_kv = rms_norm(x @ params["w_dkv"], params["kv_norm"]["gamma"])
    k_rope = (x @ params["w_kr"])[:, :, None, :]
    cos, sin = rope_angles(positions, cfg.rope_head_dim, cfg.rope_theta,
                           x.dtype)
    q_rope = apply_rope(q_rope, cos[:, :, None], sin[:, :, None])
    k_rope = apply_rope(k_rope, cos[:, :, None], sin[:, :, None])
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(params, x, cfg: MLAConfig, positions=None):
    """Full (train/prefill) MLA. x (B,T,D) -> (B,T,D), plus decode cache
    ``(c_kv (B,T,R), k_rope (B,T,rope))``."""
    b, t, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _project_qkv(params, x, cfg, positions)
    kv = (c_kv @ params["w_ukv"]).reshape(
        b, t, h, cfg.nope_head_dim + cfg.v_head_dim)
    k_nope, v = kv.split([cfg.nope_head_dim, cfg.v_head_dim], -1)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(b, t, h, cfg.rope_head_dim)], -1)
    out = flash_attention(q, k, v, causal=True,
                          scale=cfg.qk_head_dim ** -0.5)
    out = out.reshape(b, t, h * cfg.v_head_dim) @ params["w_o"]
    return out, (c_kv, k_rope[:, :, 0, :])


def mla_decode(params, x, cache_c, cache_kr, length, cfg: MLAConfig):
    """Absorbed single-token decode.

    x (B,1,D); cache_c (B,S,R); cache_kr (B,S,rope); ``length`` = current
    position. The new token's latent is written into the caches in place
    (``write_slot``: at ``length``, clamped to the last slot). Returns
    (out (B,1,D), the caches).
    """
    b = x.shape[0]
    h = cfg.n_heads
    pos = torch.full((b, 1), int(length), dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, kr_new = _project_qkv(params, x, cfg, pos)
    write_slot(cache_c, c_new, length)
    write_slot(cache_kr, kr_new[:, :, 0, :], length)

    # a cache in another dtype than x promotes, as JAX promotes
    dt = torch.promote_types(x.dtype, cache_c.dtype)
    c, kr = cache_c.to(dt), cache_kr.to(dt)
    w_ukv = params["w_ukv"].to(dt).reshape(
        cfg.kv_lora_rank, h, cfg.nope_head_dim + cfg.v_head_dim)
    w_uk = w_ukv[:, :, :cfg.nope_head_dim]              # (R,H,nope)
    w_uv = w_ukv[:, :, cfg.nope_head_dim:]              # (R,H,v)
    # absorb: q_abs (B,H,R)
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(dt), w_uk)
    logits = torch.einsum("bhr,bsr->bhs", q_abs, c)
    logits = logits + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(dt), kr)
    logits = logits * (cfg.qk_head_dim ** -0.5)
    s = cache_c.shape[1]
    valid = torch.arange(s, device=x.device)[None, None, :] <= int(length)
    w = torch.softmax(torch.where(valid, logits.float(), -1e30),
                      -1).to(x.dtype)
    ctx = torch.einsum("bhs,bsr->bhr", w.to(dt), c)     # latent context
    out = torch.einsum("bhr,rhd->bhd", ctx, w_uv)       # (B,H,v)
    out = out.reshape(b, 1, h * cfg.v_head_dim) @ params["w_o"].to(dt)
    return out, cache_c, cache_kr
