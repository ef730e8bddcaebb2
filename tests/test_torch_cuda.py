"""The port's CUDA kernels against their plain versions, on the card.

Every test needs a CUDA card and nvcc and skips without them (a CUDA kernel
has no CPU mode; the CPU tests hold the plain versions against the JAX
reference). This file imports no JAX, so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.configs import DLRMConfig
from repro_torch.kernels import ops
from repro_torch.kernels.dot_interaction import dot_interaction
from repro_torch.kernels.recflash_sls import recflash_sls
from repro_torch.models import dlrm

pytestmark = pytest.mark.cuda

# f32 sums of <= 20 unit-normal terms (SLS) or <= 128 products (Gram) in two
# orders; bf16 inputs are widened exactly, so they share the f32 bound
TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _sls_inputs(gen, h, v, d, b, lk, dtype=torch.float32):
    table = torch.randn(v, d, generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, v, (b, lk), generator=gen, device="cuda")
    return table[:h], table[h:], idx.to(torch.int32)


class TestRecFlashSLSOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("h,v,d,b,lk", [
        (32, 128, 8, 16, 4),
        (64, 512, 16, 32, 20),
        (16, 64, 32, 8, 1),
        (128, 130, 64, 8, 7),
        (20, 100, 18, 8, 5),        # D*4 B not a multiple of 16: scalar loads
    ])
    def test_vs_plain(self, gen, h, v, d, b, lk, dtype):
        hot, cold, idx = _sls_inputs(gen, h, v, d, b, lk, dtype)
        torch.testing.assert_close(recflash_sls(hot, cold, idx),
                                   ops.sls_ref(hot, cold, idx), **TOL)

    def test_all_hot_all_cold_and_unaligned(self, gen):
        hot, cold, _ = _sls_inputs(gen, 32, 64, 8, 8, 4)
        for fill in (0, 40):
            idx = torch.full((8, 4), fill, dtype=torch.int32, device="cuda")
            torch.testing.assert_close(recflash_sls(hot, cold, idx),
                                       ops.sls_ref(hot, cold, idx), **TOL)
        flat = torch.randn(64 * 8 + 1, generator=gen, device="cuda")
        table = flat[1:].view(64, 8)            # 4-byte aligned only
        idx = torch.randint(0, 64, (8, 4), generator=gen, device="cuda",
                            dtype=torch.int32)
        torch.testing.assert_close(recflash_sls(table[:32], table[32:], idx),
                                   ops.sls_ref(table[:32], table[32:], idx),
                                   **TOL)

    def test_counts_launches_and_rejects(self, gen):
        hot, cold, idx = _sls_inputs(gen, 32, 64, 8, 16, 4)
        before = recflash_sls.launches
        recflash_sls(hot, cold, idx)
        assert recflash_sls.launches == before + 1
        with pytest.raises(ValueError):
            recflash_sls(hot, cold, idx[:10])                 # 10 % 8
        with pytest.raises(TypeError):
            recflash_sls(hot, cold, idx.long())
        with pytest.raises(ValueError):
            recflash_sls(hot, cold, idx.t().contiguous().t())
        assert recflash_sls.launches == before + 1


class TestDotInteractionOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,t,d", [(64, 9, 16), (128, 27, 64),
                                       (64, 33, 128), (8, 3, 18)])
    def test_vs_plain(self, gen, b, t, d, dtype):
        z = torch.randn(b, t, d, generator=gen, device="cuda").to(dtype)
        before = dot_interaction.launches
        torch.testing.assert_close(dot_interaction(z), ops.dot_ref(z), **TOL)
        assert dot_interaction.launches == before + 1

    def test_triangle(self, gen):
        z = torch.randn(16, 5, 8, generator=gen, device="cuda")
        torch.testing.assert_close(ops.dot_interaction(z),
                                   ops.upper_triangle(ops.dot_ref(z)), **TOL)


def test_forward_kernels_vs_plain(gen):
    cfg = DLRMConfig(name="tiny", n_tables=3, n_dense=13, embed_dim=16,
                     n_rows=(500,) * 3, lookups=4, bot_mlp=(32, 16),
                     top_mlp=(32,))
    params = dlrm.init(0, cfg, device="cuda")
    perm = [torch.randperm(500, generator=gen, device="cuda")
            for _ in range(cfg.n_tables)]
    params = dlrm.add_remap(params, [p.argsort() for p in perm], [5, 50, 499])
    batch = {"dense": torch.randn(16, 13, generator=gen, device="cuda"),
             "indices": torch.randint(0, 500, (16, 3, 4), generator=gen,
                                      device="cuda", dtype=torch.int32)}
    torch.testing.assert_close(dlrm.forward(params, batch, cfg),
                               dlrm.forward(params, batch, cfg, plain=True),
                               rtol=1e-4, atol=1e-5)
