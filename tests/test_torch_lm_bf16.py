"""The qwen3 LM variant in bf16 (``repro_torch.models.lm``) against the
reference's bf16 model, on the CPU.

Tolerances: the loss ``rtol=2e-2``; hidden states, prefill and decode
logits by relative L2 2e-2 against the reference's bf16 model; each
gradient leaf no farther from the float32 gradient of the same
(bf16-valued) params than the reference's bf16 gradient is, plus 2e-2
relative L2 (the two bf16 models round in other orders, and each lands
2-3% from float32, so 2e-2 between them directly is the noise itself).
"""

import jax
import jax.numpy as jnp
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from repro.models import lm as jlm
from repro_torch.models import lm
from test_torch_lm import (JAX_VARIANTS, VARIANTS, _close, _jpad_cache,
                           _pad_cache, _port, _rel_l2, _tokens,
                           _value_and_grads, j_backbone, j_decode_step,
                           j_prefill, lm_batches)


def test_bf16_variant_matches_reference():
    name = "qwen3-1.7b"
    jcfg, cfg = JAX_VARIANTS[name], VARIANTS[name]
    jp = jlm.init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    p = _port(jp)
    assert p["embed"].dtype == torch.bfloat16
    jb, tb = lm_batches(*_tokens(2, 64, cfg.vocab, 6))
    assert _rel_l2(lm.backbone(p, tb["tokens"], cfg),
                   j_backbone(jp, jb["tokens"], jcfg)) < 2e-2
    loss_fn = jax.jit(jax.value_and_grad(
        lambda q: jlm.train_loss(q, jb, jcfg)))
    jloss, jgrads = loss_fn(jp)
    _, f32_grads = loss_fn(jax.tree.map(
        lambda a: a.astype(jnp.float32), jp))
    loss, grads = _value_and_grads(
        lambda q: lm.train_loss(q, tb, cfg), p)
    _close(loss, jloss, dict(rtol=2e-2, atol=0))
    ref = {keystr(k): g for k, g in tree_flatten_with_path(jgrads)[0]}
    f32 = {keystr(k): g for k, g in tree_flatten_with_path(f32_grads)[0]}
    for path, g in grads.items():
        assert g.dtype == torch.bfloat16, path
        assert _rel_l2(g, f32[path]) <= \
            _rel_l2(ref[path], f32[path]) + 2e-2, path
    logits, cache = lm.prefill(p, tb["tokens"][:, :32], cfg)
    jlogits, jcache = j_prefill(jp, jb["tokens"][:, :32], jcfg)
    assert cache["k"].dtype == torch.bfloat16
    assert _rel_l2(logits, jlogits) < 2e-2
    got, _ = lm.decode_step(p, _pad_cache(cache), tb["tokens"][:, 32],
                            32, cfg)
    want, _ = j_decode_step(jp, _jpad_cache(jcache),
                              jb["tokens"][:, 32], 32, jcfg)
    assert _rel_l2(got, want) < 2e-2
