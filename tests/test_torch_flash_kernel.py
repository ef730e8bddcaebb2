"""The flash attention kernel's wrappers (``kernels.flash_attention``) on the
CPU, where they run the kernel's plain version (``kernels.ref``), and that
plain version against the JAX reference at the cases the kernel must keep.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``,
marked ``cuda``). Here:

- on CPU and meta tensors the wrappers run the plain version and launch
  nothing (the dry-run and ``op_stats`` count the plain chunk loop's
  operations, unchanged by the kernel);
- the contract the wrappers hold on every device, the head-dim buckets
  they pick for the kernel and the route each (dtype, bucket) takes on the
  card (bf16 on wgmma, float32 on the CUDA cores, both on the same
  instances, two backward launches a call), counted per route;
- the plain version against ``repro.models.attention.flash_attention`` for
  rows that see no key (``q_start < 0``) and for a ``v`` that is a split
  view: float32, the reference's own tolerances (output ``atol=2e-5``,
  gradients ``5e-4``, ``rtol=0``; tests/test_attention.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch.op_stats import op_stats
from repro_torch.models import attention
from repro_torch.models import lm as plm
from test_torch_lm import _close

OUT_TOL = dict(rtol=0, atol=2e-5)
GRAD_TOL = dict(rtol=0, atol=5e-4)


def _qkv(b, t, s, h, kv, dq, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, dq)).astype(np.float32),
            rng.standard_normal((b, s, kv, dq)).astype(np.float32),
            rng.standard_normal((b, s, kv, dv)).astype(np.float32),
            rng.standard_normal((b, t, h, dv)).astype(np.float32))


def _counts():
    """Both wrappers' launches, in all and by route."""
    return (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches,
            dict(fa.flash_attention_fwd.routes),
            dict(fa.flash_attention_bwd.routes))


def _meta(*shape):
    return torch.empty(shape, device="meta")


class TestWrappersOffTheCard:
    def test_cpu_runs_the_plain_version_and_launches_nothing(self):
        q, k, v, do = map(torch.from_numpy, _qkv(2, 256, 256, 6, 2, 32, 32))
        args = (0, True, 64, 128, 32 ** -0.5)
        before = _counts()
        out, lse = ops.flash_attention_fwd(q, k, v, *args)
        w_out, w_lse = ref.flash_attention_fwd_ref(q, k, v, *args)
        assert torch.equal(out, w_out) and torch.equal(lse, w_lse)
        assert lse.shape == (2, 2, 256 * 3) and lse.dtype == torch.float32
        got = ops.flash_attention_bwd(q, k, v, out, lse, do, *args)
        want = ref.flash_attention_bwd_ref(q, k, v, w_out, w_lse, do, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
        assert _counts() == before

    @pytest.mark.parametrize("dq,dv,h,kv", [(192, 128, 4, 4), (128, 128, 16, 8),
                                            (48, 32, 4, 4), (256, 64, 2, 1)])
    def test_meta_gives_shapes_and_launches_nothing(self, dq, dv, h, kv):
        """MLA's 192/128 among them, its v a split view; a dim the kernel
        does not take (256) still runs the plain version's shapes."""
        before = _counts()
        q, k = _meta(2, 512, h, dq), _meta(2, 512, kv, dq)
        v = _meta(2, 512, kv, 128 + dv).split([128, dv], -1)[1]
        args = (0, True, 256, 512, dq ** -0.5)
        out, lse = fa.flash_attention_fwd(q, k, v, *args)
        assert (out.shape, out.device.type) == ((2, 512, h, dv), "meta")
        assert lse.shape == (2, kv, 512 * (h // kv))
        grads = fa.flash_attention_bwd(q, k, v, out, lse, _meta(*out.shape),
                                       *args)
        assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
        assert _counts() == before

    def test_contract_raises_on_every_device(self):
        q, k, v, _ = map(torch.from_numpy, _qkv(1, 128, 128, 4, 2, 16, 16))
        with pytest.raises(ValueError):                    # T % q_chunk
            fa.flash_attention_fwd(q, k, v, 0, True, 96, 128, 0.25)
        with pytest.raises(ValueError):                    # S % kv_chunk
            fa.flash_attention_fwd(q, k, v, 0, True, 128, 96, 0.25)
        with pytest.raises(ValueError):                    # 4 over 3 heads
            fa.flash_attention_fwd(q, k[:, :, :1].expand(1, 128, 3, 16),
                                   v[:, :, :1].expand(1, 128, 3, 16), 0,
                                   True, 128, 128, 0.25)
        with pytest.raises(TypeError):
            fa.flash_attention_fwd(q.double(), k.double(), v.double(), 0,
                                   True, 128, 128, 0.25)
        with pytest.raises(TypeError):
            fa.flash_attention_fwd(q.bfloat16(), k, v, 0, True, 128, 128,
                                   0.25)

    @pytest.mark.parametrize("dims,want", [
        ((16, 16), (32, 32)), ((24, 16), (32, 32)), ((32, 32), (32, 32)),
        ((48, 32), (48, 32)), ((40, 40), (64, 64)), ((64, 32), (64, 64)),
        ((128, 64), (128, 128)), ((192, 128), (192, 128)),
        ((136, 128), (192, 128))])
    def test_buckets(self, dims, want):
        assert fa.bucket(*dims) == want

    @pytest.mark.parametrize("dims", [(256, 64), (64, 136), (12, 16),
                                      (32, 20), (0, 32)])
    def test_bucket_raises_for_dims_the_kernel_does_not_take(self, dims):
        with pytest.raises(ValueError):
            fa.bucket(*dims)

    @pytest.mark.parametrize("dims", fa.BUCKETS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_route_of_every_dtype_and_bucket(self, dtype, dims):
        """float32 runs on the CUDA cores and bf16 on wgmma, both on the
        same instance: the bucket's own, or 64/64 for a bucket under it
        (zero-padded); each route makes two backward launches a call."""
        way, inst = fa.route(dtype, dims)
        assert way == {torch.float32: "cuda_cores",
                       torch.bfloat16: "wgmma"}[dtype]
        assert inst == (dims if dims in fa.INSTANCES else (64, 64))
        assert fa.BWD_LAUNCHES[way] == 2
        assert set(fa.ROUTE_CODES) == set(fa.flash_attention_fwd.routes) \
            == set(fa.flash_attention_bwd.routes) == set(fa.BWD_LAUNCHES)

    @pytest.mark.parametrize("dtype,dims,exc", [
        (torch.float16, (64, 64), TypeError),
        (torch.float64, (128, 128), TypeError),
        (torch.bfloat16, (96, 96), ValueError),
        (torch.bfloat16, (256, 128), ValueError),
        (torch.float32, (64, 128), ValueError)])
    def test_route_raises_for_what_no_route_takes(self, dtype, dims, exc):
        with pytest.raises(exc):
            fa.route(dtype, dims)

    def test_launcher_args_refuse_a_tensor_off_the_card(self):
        q, k, v, _ = map(torch.from_numpy, _qkv(1, 64, 64, 2, 1, 48, 32))
        with pytest.raises(ValueError, match="unsupported device"):
            fa._cuda_args(q.bfloat16(), k.bfloat16(), v.bfloat16(), 0, True)


class TestPlainVersionAgainstReference:
    def _both(self, q, k, v, do, kw, v_view=None):
        """Forward and gradients of the port (``v_view`` in place of ``v``
        where given) and of the reference on the same numbers."""
        tq, tk = (torch.from_numpy(x).requires_grad_() for x in (q, k))
        if v_view is None:
            tv = leaf = torch.from_numpy(v).requires_grad_()
        else:
            leaf = torch.from_numpy(v_view).requires_grad_()
            tv = leaf.split([v_view.shape[-1] - v.shape[-1], v.shape[-1]],
                            -1)[1]
            assert not tv.is_contiguous() and tv.stride(-1) == 1
        out = attention.flash_attention(tq, tk, tv, **kw)
        grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        want = jattn.flash_attention(jq, jk, jv, **kw)
        _, vjp = jax.vjp(lambda *a: jattn.flash_attention(*a, **kw),
                         jq, jk, jv)
        _close(out, want, OUT_TOL)
        for g, w in zip(grads, vjp(jnp.asarray(do)), strict=True):
            _close(g, w, GRAD_TOL)
        return out

    @pytest.mark.parametrize("n_rep", [1, 2])
    def test_rows_that_see_no_key(self, n_rep):
        """q_start < 0: the first rows sit before key 0. With the finite
        NEG_INF each is the mean of v, and its backward p is 1 on every
        key; the chunks are visited, not skipped."""
        h = 2 * n_rep
        q, k, v, do = _qkv(2, 256, 256, h, 2, 32, 32, seed=1)
        out = self._both(q, k, v, do, dict(causal=True, q_chunk=64,
                                           kv_chunk=128, q_start=-100))
        mean = torch.from_numpy(v).mean(1, keepdim=True)
        mean = mean.repeat_interleave(n_rep, 2).expand(2, 100, h, 32)
        _close(out.detach()[:, :100], mean.numpy(), OUT_TOL)

    def test_v_split_view(self):
        """MLA's v: a split view of a wider tensor, its rows strided."""
        q, k, v, do = _qkv(1, 512, 512, 4, 4, 48, 32, seed=2)
        wide = np.concatenate([np.zeros((1, 512, 4, 16), np.float32), v], -1)
        self._both(q, k, v, do, dict(causal=True, q_chunk=128, kv_chunk=256,
                                     scale=48 ** -0.5), v_view=wide)


def test_op_stats_counts_the_plain_chunk_loop():
    """On meta the dry-run and ``op_stats`` count the plain version's
    operations: both products of every (query chunk, kv chunk) pair that
    the causal skip visits; and a narrow qwen3-1.7b prefill over several
    chunks counts what it counted before the kernel came."""
    b, t, h, kv, d, qc, kc = 2, 2048, 4, 2, 64, 256, 512
    got = op_stats(lambda q, k, v: attention.flash_attention(
        q, k, v, q_chunk=qc, kv_chunk=kc), _meta(b, t, h, d),
        _meta(b, t, kv, d), _meta(b, t, kv, d))["flops"]
    pairs = sum((i * qc + qc - 1) // kc + 1 for i in range(t // qc))
    assert got == pairs * 2 * (2 * b * kv * (qc * h // kv) * kc * d)
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
              d_ff=128, vocab=256)
    bundle = configs.get_arch("qwen3-1.7b")
    cfg = dataclasses.replace(bundle.cfg, **kw)
    bundle = dataclasses.replace(bundle, cfg=cfg,
                                 init=functools.partial(plm.init, cfg=cfg))
    plan = bundle.steps["prefill_32k"].make_fn(bundle, None, False)
    stats = op_stats(plan.fn, plan.args[0],
                     torch.empty((2, 2048), dtype=torch.int32, device="meta"))
    assert stats["flops"] == 3825270784
