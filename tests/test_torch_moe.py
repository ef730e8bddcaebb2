"""The port's local MoE (``repro_torch.models.moe``) and the qwen3-moe LM
variant against the JAX reference, on the CPU.

Which assignments an expert drops under its capacity must be the
reference's, to the token. The outputs are held to a tolerance, not to
bit-equality (the scatter-add combines in another order): float32
``rtol=atol=1e-5``; expert ids and kept counts exactly; bf16 (a bf16 model
with a float32 router) ``rtol=atol=2e-2``. The LM variant is held as in
tests/test_torch_lm.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe
from test_torch_lm import (BF16_TOL, TOL, _check_grads, _close, _port,
                           _value_and_grads, check_forward_loss_and_grads,
                           check_prefill_and_decode)

KW = dict(d_model=32, d_expert=16, n_experts=8, top_k=2)
# the reference's functions, jitted (one compile beats op-by-op dispatch)
j_moe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=2)
j_route = jax.jit(jmoe._route, static_argnums=2)


def _cfgs(**kw):
    kw = {**KW, **kw}
    return jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)


def _setup(seed=0, n_tok=64, dtype=jnp.float32, **kw):
    jcfg, cfg = _cfgs(**kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, dtype)
    if "router_b" in jp:          # a nonzero bias that changes the picks
        jp["router_b"] = jnp.asarray(np.random.default_rng(seed).normal(
            0, 0.05, jcfg.n_experts), jnp.float32)
    x = np.random.default_rng(seed + 1).standard_normal(
        (n_tok, jcfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, _port(jp), jnp.asarray(x, dtype), \
        _port(jnp.asarray(x, dtype))


def _kept(top_e: np.ndarray, n_experts: int, cap: int):
    """The reference's kept assignments, from its expert picks: a stable
    sort by expert keeps each expert's first ``cap`` in flat order."""
    flat = top_e.reshape(-1)
    order = np.argsort(flat, kind="stable")
    starts = np.searchsorted(flat[order], np.arange(n_experts))
    keep = set()
    for i, a in enumerate(order):
        if i - starts[flat[a]] < cap:
            keep.add(int(a))
    return keep


class TestRoute:
    @pytest.mark.parametrize("kw", [dict(), dict(router_bias=True),
                                    dict(norm_topk=False)])
    def test_matches_reference(self, kw):
        jcfg, cfg, jp, p, jx, x = _setup(**kw)
        top_p, top_e = moe._route(p, x, cfg)
        jtop_p, jtop_e = j_route(jp, jx, jcfg)
        np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
        _close(top_p, jtop_p)

    def test_ties_go_to_the_lower_index(self):
        """Equal scores (duplicated router columns) pick as ``lax.top_k``
        does."""
        jcfg, cfg, jp, p, jx, x = _setup()
        router = np.asarray(jp["router"]).copy()
        router[:, 5] = router[:, 2]
        router[:, 7] = router[:, 2]
        jp["router"] = jnp.asarray(router)
        p["router"] = torch.from_numpy(router)
        _, top_e = moe._route(p, x, cfg)
        _, jtop_e = j_route(jp, jx, jcfg)
        np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
        vals = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
        _, idx = moe.top_k(vals, 3)
        assert idx.tolist() == [[1, 2, 4]]


class TestMoEFFN:
    @pytest.mark.parametrize("kw", [
        dict(),
        dict(n_shared=1, router_bias=True),
        dict(act="squared_relu"),
    ])
    def test_matches_reference(self, kw):
        jcfg, cfg, jp, p, jx, x = _setup(capacity_factor=1.5, **kw)
        _close(moe.moe_ffn(p, x, cfg), j_moe_ffn(jp, jx, jcfg))

    def test_clipping_drops_the_reference_assignments(self):
        """capacity_factor 0.5: slots are half the assignments, so most
        experts clip. The same assignments are kept (per expert counts
        and the set itself) and the outputs agree."""
        jcfg, cfg, jp, p, jx, x = _setup(capacity_factor=0.5, n_tok=64)
        cap = moe._cap_per_expert(cfg, 64)
        assert cap == jmoe._cap_per_expert(jcfg, 64) == 8
        _, top_e = moe._route(p, x, cfg)
        le = top_e.reshape(-1)
        order, le_s, _, ok = moe._slots(
            le, torch.ones_like(le, dtype=torch.bool), cfg.n_experts, cap)
        kept = set(order[ok].tolist())
        _, jtop_e = j_route(jp, jx, jcfg)
        want = _kept(np.asarray(jtop_e), cfg.n_experts, cap)
        assert kept == want
        assert len(kept) < le.numel()                  # something clipped
        np.testing.assert_array_equal(
            torch.bincount(le_s[ok], minlength=cfg.n_experts).numpy(),
            np.bincount(np.asarray(jtop_e).reshape(-1)[sorted(want)],
                        minlength=cfg.n_experts))
        _close(moe.moe_ffn(p, x, cfg), j_moe_ffn(jp, jx, jcfg))

    def test_batch_composition_dependence(self):
        """The reference's bisect (tests/test_models.py): under a finite
        capacity the same leading tokens give other outputs when one more
        token joins the call; unclipped, they do not."""
        jcfg, cfg, jp, p, jx, x = _setup(capacity_factor=0.5, n_tok=64)
        full = moe.moe_ffn(p, x, cfg)[:63]
        pre = moe.moe_ffn(p, x[:63], cfg)
        jfull = j_moe_ffn(jp, jx, jcfg)[:63]
        jpre = j_moe_ffn(jp, jx[:63], jcfg)
        assert float((full - pre).abs().max()) > 1e-6
        _close(full, jfull)
        _close(pre, jpre)
        ocfg = dataclasses.replace(cfg, capacity_factor=100.0)
        _close(moe.moe_ffn(p, x, ocfg)[:63], moe.moe_ffn(p, x[:63], ocfg),
               dict(rtol=0, atol=1e-6))

    def test_bf16_with_f32_router(self):
        jcfg, cfg, jp, p, jx, x = _setup(dtype=jnp.bfloat16, n_shared=1,
                                         router_bias=True)
        assert p["router"].dtype == torch.float32
        assert p["w_gate"].dtype == torch.bfloat16
        out = moe.moe_ffn(p, x, cfg)
        assert out.dtype == torch.bfloat16
        _close(out, j_moe_ffn(jp, jx, jcfg), BF16_TOL)

    def test_load_balance_loss(self):
        jcfg, cfg, jp, p, jx, x = _setup()
        _close(moe.load_balance_loss(p, x, cfg),
               jmoe.load_balance_loss(jp, jx, jcfg))

    def test_gradients_match_reference(self):
        jcfg, cfg, jp, p, jx, x = _setup(capacity_factor=0.5, n_shared=1)
        want = jax.jit(jax.grad(
            lambda q: (jmoe.moe_ffn(q, jx, jcfg) ** 2).mean()))(jp)
        _, got = _value_and_grads(
            lambda q: (moe.moe_ffn(q, x, cfg) ** 2).mean(), p)
        _check_grads(got, want, TOL)


class TestQwen3MoEVariant:
    """tests/test_models.py's qwen3-moe LM variant (8 experts, top-2,
    capacity 2.0) through the whole LM."""
    name = "qwen3-moe-30b-a3b"

    def test_forward_loss_and_grads_match_reference(self):
        check_forward_loss_and_grads(self.name)

    def test_prefill_and_decode_match_reference(self):
        check_prefill_and_decode(self.name)
