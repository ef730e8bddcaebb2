"""The port's attention and its helpers (``repro_torch.models.{common,
attention}``) against the JAX reference, on the CPU.

The same seeded numpy inputs go through both packages. Tolerances:

- ``flash_attention`` against the reference's ``flash_attention`` (its
  ``custom_vjp``): float32 forward ``atol=2e-5`` and gradients
  ``atol=5e-4``, the reference's own (tests/test_attention.py); bf16
  ``rtol=atol=2e-2`` forward, gradients by relative L2 2e-2;
- the common helpers and decode attention: float32 ``rtol=atol=1e-5``
  (sums in other orders, each O(1e-7) relative); bf16 one rounding apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.models import attention, common
from test_torch_lm import BF16_TOL, TOL, _close, _port, _rel_l2

# ------------------------------------------------------------ common ----
class TestCommon:
    def test_rms_norm_and_init(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 5, 16)).astype(np.float32)
        g = rng.standard_normal(16).astype(np.float32)
        _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(g)),
               jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g)))
        xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
        got = common.rms_norm(_port(xb), _port(gb))
        assert got.dtype == torch.bfloat16
        # one bf16 rounding of the same products
        _close(got, jcommon.rms_norm(xb, gb), dict(rtol=2**-7, atol=1e-2))
        init = common.rms_init(16, torch.bfloat16)
        assert init["gamma"].dtype == torch.bfloat16
        _close(init["gamma"], jcommon.rms_init(16)["gamma"])

    def test_squared_relu(self):
        x = np.linspace(-3, 3, 13).astype(np.float32)
        _close(common.squared_relu(torch.from_numpy(x)),
               jcommon.squared_relu(jnp.asarray(x)))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_rope_angles_and_apply(self, dtype):
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        pos = np.arange(40, dtype=np.int32)[None].repeat(2, 0)
        cos, sin = common.rope_angles(torch.from_numpy(pos), 16, 1e6, dtype)
        jcos, jsin = jcommon.rope_angles(jnp.asarray(pos), 16, 1e6, jdt)
        assert cos.dtype == dtype and cos.shape == (2, 40, 8)
        tol = TOL if dtype == torch.float32 else dict(rtol=2**-7, atol=4e-3)
        _close(cos, jcos, tol)
        _close(sin, jsin, tol)
        x = np.random.default_rng(1).standard_normal((2, 40, 3, 16))
        x = x.astype(np.float32)
        got = common.apply_rope(torch.from_numpy(x).to(dtype),
                                cos[:, :, None], sin[:, :, None])
        want = jcommon.apply_rope(jnp.asarray(x, jdt), jcos[:, :, None],
                                  jsin[:, :, None])
        _close(got, want, tol if dtype == torch.float32
               else dict(rtol=2e-2, atol=2e-2))


# --------------------------------------------------------- attention ----
def _qkv(b, t, s, h, kv, dq, dv=None, seed=0):
    rng = np.random.default_rng(seed)
    dv = dv or dq
    return (rng.standard_normal((b, t, h, dq)).astype(np.float32),
            rng.standard_normal((b, s, kv, dq)).astype(np.float32),
            rng.standard_normal((b, s, kv, dv)).astype(np.float32))


# tests/test_attention.py's CASES, plus the dense fallback
CASES = [
    dict(b=2, t=1024, s=1024, h=4, kv=2, dq=64, causal=True),    # GQA
    dict(b=1, t=512, s=2048, h=8, kv=8, dq=32, causal=True),     # t < s
    dict(b=2, t=1024, s=1024, h=6, kv=3, dq=64, causal=False),   # bidir
    dict(b=2, t=512, s=512, h=4, kv=4, dq=48, dv=32, causal=True),  # MLA dims
    dict(b=2, t=96, s=96, h=4, kv=2, dq=16, causal=True),        # 96 % 256
]


def _loss_of(fn):
    return lambda q, k, v: (fn(q, k, v) ** 2).sum()


class TestFlashAttention:
    @pytest.mark.parametrize("case", CASES)
    def test_forward_and_grads_match_reference(self, case):
        q, k, v = _qkv(case["b"], case["t"], case["s"], case["h"],
                       case["kv"], case["dq"], case.get("dv"))
        kw = dict(causal=case["causal"], q_chunk=256, kv_chunk=256,
                  scale=case["dq"] ** -0.5)
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = attention.flash_attention(tq, tk, tv, **kw)
        _close(out, jattn.flash_attention(jq, jk, jv, **kw),
               dict(rtol=0, atol=2e-5))
        want = jax.jit(jax.grad(_loss_of(
            lambda *a: jattn.flash_attention(*a, **kw)),
            argnums=(0, 1, 2)))(jq, jk, jv)
        got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
        for g, w in zip(got, want, strict=True):
            _close(g, w, dict(rtol=0, atol=5e-4))

    def test_gradients_come_from_the_function(self):
        """The backward is FlashAttention's own Function, which saves
        q, k, v, out and lse only: nothing of (T, S) size."""
        q, k, v = (torch.from_numpy(x).requires_grad_()
                   for x in _qkv(1, 1024, 1024, 2, 2, 32))
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda x: saved.append(x) or x, lambda x: x):
            out = attention.flash_attention(q, k, v, q_chunk=256,
                                            kv_chunk=256)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        assert len(saved) == 5
        limit = 4 * 1024 * 1024          # one f32 (T, S) block
        assert all(x.numel() * x.element_size() < limit for x in saved)

    def test_explicit_q_start(self):
        """A sequence shard of queries with its global offset equals the
        same rows of the whole causal attention, on both sides."""
        q, k, v = _qkv(2, 512, 1024, 4, 2, 32, seed=2)
        kw = dict(causal=True, q_chunk=128, kv_chunk=256, q_start=256)
        got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                        **kw)
        _close(got, jattn.flash_attention(*map(jnp.asarray, (q, k, v)), **kw),
               dict(rtol=0, atol=2e-5))
        qf = np.zeros((2, 1024, 4, 32), np.float32)
        qf[:, 256:768] = q
        full = attention.attention_dense(*map(torch.from_numpy, (qf, k, v)))
        _close(got, full[:, 256:768], dict(rtol=0, atol=2e-5))
        with pytest.raises(ValueError):
            attention.flash_attention(*map(torch.from_numpy, _qkv(
                1, 96, 96, 2, 2, 8)), q_chunk=64, q_start=0)

    def test_bf16_matches_reference(self):
        q, k, v = _qkv(2, 512, 512, 4, 2, 32, seed=3)
        kw = dict(causal=True, q_chunk=128, kv_chunk=256)
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        tq, tk, tv = (_port(x).requires_grad_() for x in (jq, jk, jv))
        out = attention.flash_attention(tq, tk, tv, **kw)
        assert out.dtype == torch.bfloat16
        _close(out, jattn.flash_attention(jq, jk, jv, **kw), BF16_TOL)
        want = jax.grad(lambda *a: jattn.flash_attention(*a, **kw).astype(
            jnp.float32).sum(), argnums=(0, 1, 2))(jq, jk, jv)
        got = torch.autograd.grad(out.float().sum(), (tq, tk, tv))
        for g, w in zip(got, want, strict=True):
            assert g.dtype == torch.bfloat16
            assert _rel_l2(g, w) < 2e-2


class TestDecodeAttention:
    def test_scalar_and_per_row_lengths(self):
        rng = np.random.default_rng(4)
        b, s, h, kv, dh = 3, 64, 4, 2, 16
        q = rng.standard_normal((b, h, dh)).astype(np.float32)
        kc = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
        vc = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
        tq, tk, tv = map(torch.from_numpy, (q, kc, vc))
        for length in (40, np.array([5, 40, 64], np.int32)):
            got = attention.decode_attention(tq, tk, tv,
                                             torch.as_tensor(length))
            _close(got, jattn.decode_attention(
                *map(jnp.asarray, (q, kc, vc)), jnp.asarray(length)))
        lengths = [5, 40, 64]
        got = attention.decode_attention(tq, tk, tv, torch.tensor(lengths))
        for i, n in enumerate(lengths):
            # each row attends its own valid prefix only
            want = attention.attention_dense(tq[i:i + 1, None],
                                             tk[i:i + 1, :n], tv[i:i + 1, :n],
                                             causal=False)[:, 0]
            _close(got[i:i + 1], want)
