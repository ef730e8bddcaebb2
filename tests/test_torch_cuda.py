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
from repro_torch.kernels.dot_interaction import (dot_interaction,
                                                 dot_interaction_fused)
from repro_torch.kernels.recflash_sls import (PIPELINE_DEPTHS, describe,
                                              recflash_sls,
                                              recflash_sls_grouped)
from repro_torch.kernels.ref import (recflash_sls_grouped_ref,
                                     recflash_sls_ref)
from repro_torch.models import dlrm

pytestmark = pytest.mark.cuda

# f32 sums of <= 80 unit-normal terms (SLS) or <= 128 products (Gram) in two
# orders; bf16 inputs are widened exactly, so they share the f32 bound
TOL = dict(rtol=1e-5, atol=1e-4)
# a bf16 output is each side's f32 sum rounded once, so the two may also be
# one bf16 ulp apart: 2^-7 relative at most (the SLS adds in one order on
# both sides and rounds the same sum, so it is bit-equal in practice)
BF16_OUT_TOL = dict(rtol=2**-7, atol=1e-4)


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

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b", [1, 9, 4096])
    def test_bit_equal_to_plain(self, gen, dtype, b):
        hot, cold, idx = _sls_inputs(gen, 64, 3000, 64, b, 40, dtype)
        idx[0, :5] = torch.tensor([-1, 2999, 3000, 2**31 - 1, 63],
                                  dtype=torch.int32)
        assert torch.equal(recflash_sls(hot, cold, idx, block_b=1),
                           ops.sls_ref(hot, cold, idx))

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


def _group(gen, rows, d, hot_sizes, b, lk, dtype=torch.float32,
           remap=True, case="mixed"):
    """Stored tables, their rank_of (or None) and (B, n_tables, L) ids
    whose ranks fall in the hot tier, the cold tier or either (case)."""
    tables, rank_of, ids = [], [], []
    for v, h in zip(rows, hot_sizes, strict=True):
        tables.append(torch.randn(v, d, generator=gen, device="cuda")
                      .to(dtype))
        lo, hi = {"mixed": (0, v), "all-hot": (0, h),
                  "all-cold": (min(h, v - 1), v)}[case]
        ranks = torch.randint(lo, hi, (b, lk), generator=gen, device="cuda")
        perm = torch.randperm(v, generator=gen, device="cuda")
        rank_of.append(perm.argsort().to(torch.int32))
        ids.append(perm[ranks] if remap else ranks)
    idx = torch.stack(ids, dim=1).to(torch.int32)
    return tables, (rank_of if remap else None), idx


# ragged bags of 1 to 100 ids (DLRM-DCNv2's range) over four tables
RAGGED_ROWS, RAGGED_HOT, RAGGED_LOOKUPS = ((64, 100, 130, 3000),
                                          (1, 17, 129, 30), (1, 100, 7, 33))


def _ragged(gen, b, dtype):
    """Stored tables, their rank_of, (B, sum(lookups)) int32 ids drawn over
    each table's rows, and the bag lengths."""
    tables = [torch.randn(v, 64, generator=gen, device="cuda").to(dtype)
              for v in RAGGED_ROWS]
    rank_of = [torch.randperm(v, generator=gen, device="cuda")
               .to(torch.int32) for v in RAGGED_ROWS]
    idx = torch.cat([torch.randint(0, v, (b, n), generator=gen,
                                   device="cuda")
                     for v, n in zip(RAGGED_ROWS, RAGGED_LOOKUPS,
                                     strict=True)], dim=1)
    return tables, rank_of, idx.to(torch.int32), RAGGED_LOOKUPS


class TestRecFlashSLSGroupedOnCard:
    ROWS, HOT = (64, 100, 130), (1, 17, 129)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("case", ["mixed", "all-hot", "all-cold"])
    @pytest.mark.parametrize("remap", [True, False])
    def test_vs_plain(self, gen, dtype, case, remap):
        tables, rank_of, idx = _group(gen, self.ROWS, 64, self.HOT, 16, 20,
                                      dtype, remap, case)
        before = recflash_sls_grouped.launches
        got = recflash_sls_grouped(tables, self.HOT, idx, rank_of)
        assert recflash_sls_grouped.launches == before + 1
        torch.testing.assert_close(
            got, ops.sls_grouped_ref(tables, self.HOT, idx, rank_of), **TOL)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d,lk", [(18, 5), (8, 1), (128, 80), (64, 33)])
    def test_widths_and_lookups(self, gen, dtype, d, lk):
        # D=18: scalar path; L=80 and 33 run the 8-slot ring past its depth
        tables, rank_of, idx = _group(gen, self.ROWS, d, self.HOT, 8, lk,
                                      dtype)
        torch.testing.assert_close(
            recflash_sls_grouped(tables, self.HOT, idx, rank_of),
            ops.sls_grouped_ref(tables, self.HOT, idx, rank_of), **TOL)

    def test_strided_indices_and_descriptors(self, gen):
        tables, rank_of, idx = _group(gen, self.ROWS, 64, self.HOT, 16, 20)
        strided = idx.permute(0, 2, 1).contiguous().permute(0, 2, 1)
        assert not strided.is_contiguous()
        want = ops.sls_grouped_ref(tables, self.HOT, idx, rank_of)
        desc = describe(tables, self.HOT, rank_of)
        torch.testing.assert_close(
            recflash_sls_grouped(tables, self.HOT, strided, rank_of, desc),
            want, **TOL)
        before = recflash_sls_grouped.launches
        replaced = [tables[0].clone()] + tables[1:]
        with pytest.raises(ValueError):
            recflash_sls_grouped(replaced, self.HOT, idx, rank_of, desc)
        with pytest.raises(ValueError):
            recflash_sls_grouped(tables, (2,) + self.HOT[1:], idx, rank_of,
                                 desc)
        with pytest.raises(TypeError):
            recflash_sls_grouped(tables, self.HOT, idx.long(), rank_of, desc)
        assert recflash_sls_grouped.launches == before

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b", [1, 7, 9, 4096])
    @pytest.mark.parametrize("d", [64, 18])
    def test_bit_equal_at_every_batch_edge(self, gen, dtype, b, d):
        # a block holds 128 / G samples of one table: at B = 1, 7 and 9
        # each table's last block is partly empty; D = 18 is the scalar path
        tables, rank_of, idx = _group(gen, self.ROWS, d, self.HOT, b, 20,
                                      dtype)
        assert torch.equal(
            recflash_sls_grouped(tables, self.HOT, idx, rank_of),
            ops.sls_grouped_ref(tables, self.HOT, idx, rank_of))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b", [1, 9, 4096])
    def test_ragged_bit_equal_with_bags_of_1_and_100(self, gen, dtype, b):
        tables, rank_of, idx, lookups = _ragged(gen, b, dtype)
        hot = RAGGED_HOT
        assert torch.equal(
            recflash_sls_grouped(tables, hot, idx, rank_of, lookups=lookups),
            ops.sls_grouped_ref(tables, hot, idx, rank_of, lookups))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_out_of_range_ids_clamp_bit_equal(self, gen, dtype):
        tables, rank_of, idx = _group(gen, self.ROWS, 64, self.HOT, 9, 20,
                                      dtype)
        bad = torch.tensor([-2**31, -1, 63, 64, 100, 129, 130, 2**31 - 1],
                           dtype=torch.int32, device="cuda")
        where = torch.randint(0, idx.numel(), (200,), generator=gen,
                              device="cuda")
        idx.view(-1)[where] = bad[torch.randint(0, len(bad), (200,),
                                                generator=gen,
                                                device="cuda")]
        for ro in (rank_of, None):
            assert torch.equal(
                recflash_sls_grouped(tables, self.HOT, idx, ro),
                ops.sls_grouped_ref(tables, self.HOT, idx, ro))
            flat = idx.flatten(1)
            assert torch.equal(
                recflash_sls_grouped(tables, self.HOT, flat, ro,
                                     lookups=(20,) * 3),
                ops.sls_grouped_ref(tables, self.HOT, flat, ro, (20,) * 3))

    def test_ragged_launch_captured_and_replayed(self, gen):
        tables, rank_of, idx, lookups = _ragged(gen, 9, torch.float32)
        desc = describe(tables, RAGGED_HOT, rank_of)
        static = idx.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # warm: build, attributes set
            recflash_sls_grouped(tables, RAGGED_HOT, static, rank_of, desc,
                                 lookups)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = recflash_sls_grouped.launches
        with torch.cuda.graph(graph):
            out = recflash_sls_grouped(tables, RAGGED_HOT, static, rank_of,
                                       desc, lookups)
        assert recflash_sls_grouped.launches == before
        for _ in range(3):
            _, _, new, _ = _ragged(gen, 9, torch.float32)
            static.copy_(new)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, ops.sls_grouped_ref(
                tables, RAGGED_HOT, new, rank_of, lookups))

    def test_descriptor_check_after_add_remap(self, gen):
        cfg = DLRMConfig(name="tiny", n_tables=3, n_dense=13, embed_dim=16,
                         n_rows=(500,) * 3, lookups=4, bot_mlp=(32, 16),
                         top_mlp=(32,))
        params = dlrm.add_remap(dlrm.init(0, cfg, device="cuda"),
                                [torch.arange(500)] * 3, [5, 50, 499])
        idx = torch.randint(0, 500, (16, 3, 4), generator=gen, device="cuda",
                            dtype=torch.int32)
        dlrm.bags(params, idx)
        params["tables"][1] = params["tables"][1].clone()
        with pytest.raises(ValueError):
            dlrm.bags(params, idx)


# bag lengths around each depth of the 16-byte path's register pipeline (a
# bag shorter than it, one that fills it, one that wraps once and twice),
# either side of where a launch takes the longer one, and rmc2's
PIPE_LENGTHS = tuple(sorted(
    {n for d in PIPELINE_DEPTHS for n in (1, d - 1, d, d + 1, 2 * d + 1)}
    | {2 * PIPELINE_DEPTHS[1] - 1, 2 * PIPELINE_DEPTHS[1], 120}))
# ragged launches whose bags average under and over twice the longer depth
RAGGED_SETS = {"short": PIPE_LENGTHS, "long": (25, 120, 24, 1)}


def _interleaved(gen, v, h, b, lk):
    """(b, lk) ranks of a table of v rows split at h, hot and cold in turn
    within every bag (odd bags start cold)."""
    hot = torch.randint(0, h, (b, lk), generator=gen, device="cuda")
    cold = torch.randint(h, v, (b, lk), generator=gen, device="cuda")
    turn = (torch.arange(lk, device="cuda")
            + torch.arange(b, device="cuda")[:, None]) % 2
    return torch.where(turn == 1, cold, hot)


class TestRegisterPipelineOnCard:
    """The 16-byte path at bag lengths around its pipeline's depth, hot and
    cold ranks interleaved in each bag, bit-equal to ``kernels/ref.py`` on
    every entry."""
    V, H, D, B = 3000, 100, 64, 37

    def _tables(self, gen, n, dtype):
        tables = [torch.randn(self.V, self.D, generator=gen, device="cuda")
                  .to(dtype) for _ in range(n)]
        perms = [torch.randperm(self.V, generator=gen, device="cuda")
                 for _ in range(n)]
        return tables, perms, [p.argsort().to(torch.int32) for p in perms]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("lk", PIPE_LENGTHS)
    def test_uniform(self, gen, dtype, lk):
        tables, perms, rank_of = self._tables(gen, 3, dtype)
        hot = (self.H,) * 3
        idx = torch.stack([p[_interleaved(gen, self.V, self.H, self.B, lk)]
                           for p in perms], dim=1).to(torch.int32)
        assert torch.equal(
            recflash_sls_grouped(tables, hot, idx, rank_of),
            recflash_sls_grouped_ref(tables, hot, idx, rank_of))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("lk", PIPE_LENGTHS)
    def test_per_table(self, gen, dtype, lk):
        (table,), _, _ = self._tables(gen, 1, dtype)
        ranks = _interleaved(gen, self.V, self.H, self.B, lk).to(torch.int32)
        hot, cold = table[:self.H], table[self.H:]
        assert torch.equal(recflash_sls(hot, cold, ranks, block_b=1),
                           recflash_sls_ref(hot, cold, ranks))

    def _ragged_ids(self, gen, perms, lookups):
        """(B, sum(lookups)) ids, table t's bags lookups[t] long."""
        return torch.cat([p[_interleaved(gen, self.V, self.H, self.B, lk)]
                          for p, lk in zip(perms, lookups, strict=True)],
                         dim=1).to(torch.int32)

    def _ragged(self, gen, dtype, lookups):
        n = len(lookups)
        tables, perms, rank_of = self._tables(gen, n, dtype)
        return (tables, (self.H,) * n, self._ragged_ids(gen, perms, lookups),
                rank_of, perms)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("bags", RAGGED_SETS)
    def test_ragged(self, gen, dtype, bags):
        lookups = RAGGED_SETS[bags]
        tables, hot, idx, rank_of, _ = self._ragged(gen, dtype, lookups)
        assert torch.equal(
            recflash_sls_grouped(tables, hot, idx, rank_of, lookups=lookups),
            recflash_sls_grouped_ref(tables, hot, idx, rank_of, lookups))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("bags", RAGGED_SETS)
    def test_ragged_graph_replay(self, gen, dtype, bags):
        lookups = RAGGED_SETS[bags]
        tables, hot, idx, rank_of, perms = self._ragged(gen, dtype, lookups)
        desc = describe(tables, hot, rank_of)
        static = idx.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # warm: build, attributes set
            recflash_sls_grouped(tables, hot, static, rank_of, desc, lookups)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = recflash_sls_grouped(tables, hot, static, rank_of, desc,
                                       lookups)
        for _ in range(3):
            new = self._ragged_ids(gen, perms, lookups)
            static.copy_(new)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, recflash_sls_grouped_ref(
                tables, hot, new, rank_of, lookups))


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

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b,t,d", [(64, 9, 16), (128, 27, 64),
                                       (64, 33, 128), (8, 3, 18)])
    def test_fused_vs_plain(self, gen, b, t, d, dtype):
        x = torch.randn(b, d, generator=gen, device="cuda").to(dtype)
        bags = torch.randn(b, t - 1, d, generator=gen, device="cuda").to(dtype)
        before = dot_interaction_fused.launches
        got = dot_interaction_fused(x, bags)
        assert dot_interaction_fused.launches == before + 1
        assert got.shape == (b, d + t * (t - 1) // 2)
        assert got.dtype == dtype
        torch.testing.assert_close(got, ops.fused_ref(x, bags),
                                   **(TOL if dtype == torch.float32
                                      else BF16_OUT_TOL))

    def test_fused_unaligned_rows(self, gen):
        # a row stride of 65 floats: staged by plain loads, not cp.async
        wide = torch.randn(16, 65, generator=gen, device="cuda")
        bags = torch.randn(16, 26, 64, generator=gen, device="cuda")
        x = wide[:, 1:]
        torch.testing.assert_close(dot_interaction_fused(x, bags),
                                   ops.fused_ref(x, bags), **TOL)
        with pytest.raises(ValueError):
            dot_interaction_fused(x, bags.transpose(1, 2).contiguous()
                                  .transpose(1, 2))


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
    counts = (recflash_sls_grouped.launches, dot_interaction_fused.launches,
              recflash_sls.launches, dot_interaction.launches)
    got = dlrm.forward(params, batch, cfg)
    # one grouped SLS and one fused interaction, nothing per table
    assert (recflash_sls_grouped.launches, dot_interaction_fused.launches,
            recflash_sls.launches, dot_interaction.launches) == \
        (counts[0] + 1, counts[1] + 1, counts[2], counts[3])
    torch.testing.assert_close(got,
                               dlrm.forward(params, batch, cfg, plain=True),
                               rtol=1e-4, atol=1e-5)


# gradients through the Functions (kernel forward, plain backward) against
# autograd of the plain versions: the same sums in other orders, plus
# index_add_'s atomics on the card; each tensor is held to a fraction of
# its own largest entry
GRAD_RTOL = 1e-4


def _close_grads(got, want):
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(
            a, b, rtol=GRAD_RTOL, atol=1e-5 * float(b.abs().max()))


class TestGradientsOnCard:
    @pytest.mark.parametrize("shape", ["small", "dlrm-rm2"])
    def test_sls_grouped_function(self, gen, shape):
        rows, hot, b, lk = ((64, 100, 130), (1, 17, 129), 16, 20) \
            if shape == "small" else ((1_000_000,) * 26, (2000,) * 26,
                                      4096, 80)
        tables, rank_of, idx = _group(gen, rows, 64, hot, b, lk)
        for t in tables:
            t.requires_grad_()
        g = torch.randn(b, len(rows), 64, generator=gen, device="cuda")
        before = recflash_sls_grouped.launches
        got = torch.autograd.grad(
            ops.recflash_sls_grouped(tables, hot, idx, rank_of), tables, g)
        assert recflash_sls_grouped.launches == before + 1
        want = torch.autograd.grad(
            ops.sls_grouped_ref(tables, hot, idx, rank_of), tables, g)
        _close_grads(got, want)

    @pytest.mark.parametrize("b,t,d", [(64, 9, 16), (4096, 27, 64)])
    def test_dot_interaction_fused_function(self, gen, b, t, d):
        x = torch.randn(b, d, generator=gen, device="cuda",
                        requires_grad=True)
        bags = torch.randn(b, t - 1, d, generator=gen, device="cuda",
                           requires_grad=True)
        g = torch.randn(b, d + t * (t - 1) // 2, generator=gen,
                        device="cuda")
        before = dot_interaction_fused.launches
        got = torch.autograd.grad(ops.dot_interaction_fused(x, bags),
                                  (x, bags), g)
        assert dot_interaction_fused.launches == before + 1
        want = torch.autograd.grad(ops.fused_ref(x, bags), (x, bags), g)
        _close_grads(got, want)

    def test_loss_gradients_vs_plain(self, gen):
        cfg = DLRMConfig(name="tiny", n_tables=3, n_dense=13, embed_dim=16,
                         n_rows=(500,) * 3, lookups=4, bot_mlp=(32, 16),
                         top_mlp=(32,))
        params = dlrm.init(0, cfg, device="cuda")
        leaves = [p for p in params["tables"]] + [
            v for layer in params["bot"] + params["top"]
            for v in layer.values()]
        for p in leaves:
            p.requires_grad_()
        perm = [torch.randperm(500, generator=gen, device="cuda")
                for _ in range(cfg.n_tables)]
        pp = dlrm.add_remap(params, [p.argsort().to(torch.int32)
                                     for p in perm], [5, 50, 499])
        batch = {"dense": torch.randn(16, 13, generator=gen, device="cuda"),
                 "indices": torch.randint(0, 500, (16, 3, 4), generator=gen,
                                          device="cuda", dtype=torch.int32),
                 "labels": (torch.rand(16, generator=gen, device="cuda")
                            > 0.5).float()}
        loss = dlrm.loss(pp, batch, cfg)
        plain = dlrm.loss(pp, batch, cfg, plain=True)
        torch.testing.assert_close(loss, plain, rtol=1e-5, atol=1e-6)
        _close_grads(torch.autograd.grad(loss, leaves),
                     torch.autograd.grad(plain, leaves))


def test_retrieval_score_vs_plain(gen):
    cfg = DLRMConfig(name="tiny", n_tables=3, n_dense=13, embed_dim=16,
                     n_rows=(500,) * 3, lookups=4, bot_mlp=(32, 16),
                     top_mlp=(32,))
    perm = [torch.randperm(500, generator=gen, device="cuda")
            for _ in range(cfg.n_tables)]
    params = dlrm.add_remap(dlrm.init(0, cfg, device="cuda"),
                            [p.argsort() for p in perm], [5, 50, 499])
    batch = {"dense": torch.randn(1, 13, generator=gen, device="cuda"),
             "indices": torch.randint(0, 500, (1, 3, 4), generator=gen,
                                      device="cuda", dtype=torch.int32),
             "candidates": torch.randint(0, 500, (1001,), generator=gen,
                                         device="cuda", dtype=torch.int32)}
    counts = (recflash_sls_grouped.launches, dot_interaction_fused.launches,
              recflash_sls.launches, dot_interaction.launches)
    with torch.inference_mode():
        got = dlrm.retrieval_score(params, batch, cfg)
    assert (recflash_sls_grouped.launches, dot_interaction_fused.launches,
            recflash_sls.launches, dot_interaction.launches) == \
        (counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3])
    assert got.shape == (1001,)
    torch.testing.assert_close(
        got, dlrm.retrieval_score(params, batch, cfg, plain=True),
        rtol=1e-4, atol=1e-5)


# -- the distributed embedding at world size 1 over NCCL ---------------------
# One card holds one NCCL rank (NCCL refuses two ranks on one device), so
# the card runs the mesh path on a (1, 1) mesh: every collective a group of
# one. The semantics of several ranks are held on the CPU with gloo
# (tests/test_torch_sharded.py, tests/test_torch_distributed.py).


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL has no CPU mode")
    import torch.distributed as dist

    from repro_torch.distributed import mesh as M
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    M.init("cuda", rank=0, world_size=1, store=store)
    try:
        yield M.make_mesh((1, 1), ("data", "model"), "cuda")
    finally:
        dist.destroy_process_group()


def _tiny_remapped(gen):
    cfg = DLRMConfig(name="tiny", n_tables=3, n_dense=13, embed_dim=16,
                     n_rows=(512,) * 3, lookups=4, bot_mlp=(32, 16),
                     top_mlp=(32,))
    params = dlrm.init(0, cfg, device="cuda")
    perm = [torch.randperm(512, generator=gen, device="cuda")
            for _ in range(cfg.n_tables)]
    single = dlrm.add_remap(params, [p.argsort().to(torch.int32)
                                     for p in perm], [5, 50, 511])
    batch = {"dense": torch.randn(16, 13, generator=gen, device="cuda"),
             "indices": torch.randint(0, 512, (16, 3, 4), generator=gen,
                                      device="cuda", dtype=torch.int32),
             "labels": (torch.rand(16, generator=gen, device="cuda")
                        > 0.5).float()}
    return cfg, params, single, batch


@pytest.mark.parametrize("way", ["masked-psum", "hybrid", "hybrid-2d"])
def test_mesh_forward_vs_single_device(gen, nccl_mesh, way):
    cfg, params, single, batch = _tiny_remapped(gen)
    meshp = {**params, "rank_of": single["rank_of"]}
    before = (dot_interaction_fused.launches, recflash_sls_grouped.launches)
    nccl_mesh.calls.clear()
    got = dlrm.forward(meshp, batch, cfg, nccl_mesh,
                       hybrid=way != "masked-psum", table_2d=way == "hybrid-2d")
    # the fused interaction on the rank's rows; the bags are masked gathers
    assert (dot_interaction_fused.launches, recflash_sls_grouped.launches) \
        == (before[0] + 1, before[1])
    assert sum(nccl_mesh.calls.values()) >= 2 * cfg.n_tables
    torch.testing.assert_close(got, dlrm.forward(single, batch, cfg),
                               rtol=1e-4, atol=1e-5)


def test_mesh_loss_gradients_vs_single_device(gen, nccl_mesh):
    from repro_torch import configs, tree
    from repro_torch.distributed.shardings import make_param_specs, sync_grads
    cfg, params, single, batch = _tiny_remapped(gen)
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    p = tree.unflatten(params, leaves)
    loss = dlrm.loss({**p, "rank_of": single["rank_of"]}, batch, cfg,
                     nccl_mesh, hybrid=True, table_2d=True)
    grads = sync_grads(nccl_mesh, tree.unflatten(params, list(
        torch.autograd.grad(loss, leaves))),
        make_param_specs(params, configs.PARAM_RULES_2D))
    want = dlrm.loss(dlrm.add_remap(p, single["rank_of"],
                                    single["hot_sizes"]), batch, cfg)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)
    _close_grads(tree.leaves(grads), torch.autograd.grad(want, leaves))


def test_nccl_collectives_on_one_rank(gen, nccl_mesh):
    from repro_torch.distributed.compression import (CompressionState,
                                                     compressed_psum)
    from repro_torch.distributed.mesh import all_gather, psum, psum_scatter
    ranks = torch.randint(0, 100, (8, 3), generator=gen, device="cuda",
                          dtype=torch.int32)
    assert psum(ranks, nccl_mesh, ("data", "model")).dtype == torch.int32
    assert torch.equal(psum(ranks, nccl_mesh, "model"), ranks)
    x = torch.randn(6, 4, generator=gen, device="cuda")
    assert torch.equal(psum_scatter(x, nccl_mesh, ("data", "model")), x)
    assert torch.equal(all_gather(x, nccl_mesh, "data", dim=1), x)
    g = torch.randn(64, 64, generator=gen, device="cuda")
    out, st = compressed_psum(g, "data", CompressionState.zeros_like(g), 8,
                              mesh=nccl_mesh)
    scale = torch.clamp_min(g.abs().max() / 127.0, 1e-20)
    deq = torch.clamp(torch.round(g / scale), -127, 127) * scale
    assert torch.equal(out, deq) and torch.equal(st.residual, g - deq)


def test_restore_onto_the_card_mesh(gen, nccl_mesh, tmp_path):
    from repro_torch import checkpoint, configs, tree
    from repro_torch.distributed.shardings import NamedSharding, make_param_specs
    _, params, _, _ = _tiny_remapped(gen)
    specs = make_param_specs(params, configs.PARAM_RULES_2D)
    sh = tree.tree_map(lambda s: NamedSharding(nccl_mesh, s), specs)
    checkpoint.save(str(tmp_path), 1, params, shardings=sh)
    got = checkpoint.restore(str(tmp_path), 1, params, sh)
    for a, b in zip(tree.leaves(got), tree.leaves(params), strict=True):
        assert a.device.type == "cuda" and torch.equal(a, b)


# -- bf16 DLRM, the out-of-range contract, the other recsys models -----------

def _tiny_cfg():
    return DLRMConfig(name="tiny", n_tables=3, n_dense=13, embed_dim=16,
                      n_rows=(500,) * 3, lookups=4, bot_mlp=(32, 16),
                      top_mlp=(32,))


def _tiny_bf16(gen):
    cfg = _tiny_cfg()
    params = dlrm.init(0, cfg, dtype=torch.bfloat16, device="cuda")
    perm = [torch.randperm(500, generator=gen, device="cuda")
            for _ in range(cfg.n_tables)]
    params = dlrm.add_remap(params, [p.argsort().to(torch.int32)
                                     for p in perm], [5, 50, 499])
    batch = {"dense": torch.randn(16, 13, generator=gen, device="cuda"
                                  ).to(torch.bfloat16),
             "indices": torch.randint(0, 500, (16, 3, 4), generator=gen,
                                      device="cuda", dtype=torch.int32),
             "labels": (torch.rand(16, generator=gen, device="cuda")
                        > 0.5).float()}
    return cfg, params, batch


class TestBF16OnCard:
    # the reference's bf16 tolerance: the two routes round the bags'
    # interaction dots to bf16 from f32 sums taken in other orders
    BF16_TOL = dict(rtol=2e-2, atol=2e-2)

    def test_sls_entries_store_bf16_bags(self, gen):
        hot, cold, idx = _sls_inputs(gen, 64, 512, 64, 32, 80, torch.bfloat16)
        got = recflash_sls(hot, cold, idx)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, ops.sls_ref(hot, cold, idx),
                                   rtol=0, atol=0)
        tables, rank_of, idx = _group(gen, (64, 100, 130), 64, (1, 17, 129),
                                      16, 80, torch.bfloat16)
        got = recflash_sls_grouped(tables, (1, 17, 129), idx, rank_of)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(
            got, ops.sls_grouped_ref(tables, (1, 17, 129), idx, rank_of),
            rtol=0, atol=0)

    def test_forward_and_retrieval_kernels_vs_plain(self, gen):
        cfg, params, batch = _tiny_bf16(gen)
        got = dlrm.forward(params, batch, cfg)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(
            got, dlrm.forward(params, batch, cfg, plain=True),
            **self.BF16_TOL)
        rb = {"dense": batch["dense"][:1], "indices": batch["indices"][:1],
              "candidates": torch.randint(0, 500, (777,), generator=gen,
                                          device="cuda", dtype=torch.int32)}
        with torch.inference_mode():
            got = dlrm.retrieval_score(params, rb, cfg)
        assert got.dtype == torch.bfloat16 and got.shape == (777,)
        torch.testing.assert_close(
            got, dlrm.retrieval_score(params, rb, cfg, plain=True),
            **self.BF16_TOL)

    def test_loss_gradients_vs_plain(self, gen):
        cfg, params, batch = _tiny_bf16(gen)
        from repro_torch import tree
        train = {k: params[k] for k in ("tables", "bot", "top")}
        leaves = [x.detach().requires_grad_() for x in tree.leaves(train)]
        p = dlrm.add_remap(tree.unflatten(train, leaves), params["rank_of"],
                           params["hot_sizes"])
        loss = dlrm.loss(p, batch, cfg)
        plain = dlrm.loss(p, batch, cfg, plain=True)
        torch.testing.assert_close(loss, plain, **self.BF16_TOL)
        for g, w in zip(torch.autograd.grad(loss, leaves),
                        torch.autograd.grad(plain, leaves), strict=True):
            assert g.dtype == torch.bfloat16
            assert float((g.float() - w.float()).norm()) <= \
                2e-2 * float(w.float().norm()) + 1e-6


class TestClampOnCard:
    @pytest.mark.parametrize("bad", [-1, 500, 508])
    def test_kernel_route_equals_the_cpu_route(self, gen, bad):
        """Ids -1, V and V+8 give on the card the bags and logits the CPU
        route gives, which are those of the ids clamped into [0, V)."""
        cfg, params, batch = _tiny_bf16(gen)
        idx = batch["indices"].clone()
        idx[2, 1, 3] = idx[0, 0, 0] = bad
        got = dlrm.bags(params, idx)
        cpu = {**params, "tables": [t.cpu() for t in params["tables"]],
               "rank_of": [r.cpu() for r in params["rank_of"]]}
        want = dlrm.bags(dlrm.add_remap(cpu, cpu["rank_of"],
                                        params["hot_sizes"]), idx.cpu())
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
        torch.testing.assert_close(
            got, dlrm.bags(params, idx.clamp(0, 499)), rtol=0, atol=0)
        hot, cold = params["tables"][0][:5], params["tables"][0][5:]
        r = idx[:, 0, :].contiguous()
        torch.testing.assert_close(recflash_sls(hot, cold, r).cpu(),
                                   ops.sls_ref(hot.cpu(), cold.cpu(),
                                               r.cpu()), rtol=0, atol=0)
        logits = dlrm.forward(params, {**batch, "indices": idx}, cfg)
        assert torch.isfinite(logits.float()).all()
        torch.testing.assert_close(
            logits, dlrm.forward(params, {**batch,
                                          "indices": idx.clamp(0, 499)}, cfg),
            rtol=0, atol=0)


def _recsys_tol():
    # the same float32 function on two devices: cuBLAS and the CPU's BLAS
    # sum each dot product in other orders (TF32 off)
    return dict(rtol=1e-4, atol=1e-5)


def test_din_forward_on_card_vs_cpu(gen):
    from repro_torch import tree
    from repro_torch.models import din
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = din.DINConfig(n_items=1000, seq_len=20)
    params = din.init(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    mask = torch.ones(64, 20, dtype=torch.bool)
    mask[:, 15:] = False
    batch = {"hist": torch.randint(0, 1000, (64, 20), generator=g),
             "hist_mask": mask,
             "target": torch.randint(0, 1000, (64,), generator=g),
             "profile": torch.randn(64, 8, generator=g)}
    want = din.forward(params, batch, cfg)
    on_card = tree.unflatten(params, [x.cuda() for x in tree.leaves(params)])
    got = din.forward(on_card, {k: v.cuda() for k, v in batch.items()}, cfg)
    torch.testing.assert_close(got.cpu(), want, **_recsys_tol())


def test_bert4rec_forward_on_card_vs_cpu(gen):
    from repro_torch import tree
    from repro_torch.models import bert4rec
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = bert4rec.Bert4RecConfig(n_items=500, seq_len=24)
    params = bert4rec.init(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(2)
    pad = torch.ones(8, 24, dtype=torch.bool)
    pad[:, :4] = False
    batch = {"items": torch.randint(1, 500, (8, 24), generator=g),
             "pad_mask": pad}
    want = bert4rec.score(params, batch, cfg)
    on_card = tree.unflatten(params, [x.cuda() for x in tree.leaves(params)])
    got = bert4rec.score(on_card, {k: v.cuda() for k, v in batch.items()},
                         cfg)
    torch.testing.assert_close(got.cpu(), want, **_recsys_tol())


def _lm_small(**kw):
    from repro_torch.models import lm
    base = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=256, rope_theta=10_000.0, remat=False,
                q_chunk=32, kv_chunk=32)
    return lm.LMConfig(**{**base, **kw})


def _lm_moe_mla():
    """The reduced deepseek-v3 variant: MLA, shared + routed MoE with a
    router bias, the MTP head."""
    from repro_torch.models.mla import MLAConfig
    from repro_torch.models.moe import MoEConfig
    return _lm_small(
        n_heads=4, n_kv_heads=4, n_dense_layers=1, mtp=True,
        mla=MLAConfig(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
                      nope_head_dim=16, rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(d_model=64, d_expert=32, n_experts=4, top_k=2,
                      n_shared=1, router_bias=True, capacity_factor=2.0))


def _on_card(params):
    from repro_torch import tree
    return tree.unflatten(params, [x.cuda() for x in tree.leaves(params)])


@pytest.mark.parametrize("variant", ["gqa", "moe-mla"])
def test_lm_prefill_and_decode_on_card_vs_cpu(gen, variant):
    from repro_torch.models import lm
    cfg = _lm_small(qk_norm=True) if variant == "gqa" else _lm_moe_mla()
    params = lm.init(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(3))
    pc = _on_card(params)
    with torch.inference_mode():
        want, cache = lm.prefill(params, toks[:, :64], cfg)
        got, ccache = lm.prefill(pc, toks[:, :64].cuda(), cfg)
        torch.testing.assert_close(got.cpu(), want, **_recsys_tol())
        for k in cache:
            torch.testing.assert_close(ccache[k].cpu(), cache[k],
                                       **_recsys_tol())
        grow = lambda c: {k: torch.nn.functional.pad(  # noqa: E731
            v, [0, 0] * (v.ndim - 3) + [0, 1]) for k, v in c.items()}
        want, _ = lm.decode_step(params, grow(cache), toks[:, 64], 64, cfg)
        got, _ = lm.decode_step(pc, grow(ccache), toks[:, 64].cuda(), 64,
                                cfg)
    torch.testing.assert_close(got.cpu(), want, **_recsys_tol())


def test_lm_train_step_on_card_vs_cpu(gen):
    """One AdamW step of the reduced deepseek variant (train_loss with MTP),
    card against CPU: the loss, and every updated param by relative L2."""
    from repro_torch import optim, tree
    from repro_torch.launch.train import make_step
    from repro_torch.models import lm
    cfg = _lm_moe_mla()
    params = lm.init(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(4))
    opt = optim.adamw(1e-3, weight_decay=0.1)

    def run(p, device):
        batch = {"tokens": toks[:, :-1].to(device),
                 "targets": toks[:, 1:].to(device)}
        step = make_step(opt, lambda q, b: lm.train_loss(q, b, cfg))
        return step((p, opt.init(p), None), batch)

    new_c, _, loss_c = run(_on_card(params), "cuda")
    new, _, loss = run(params, "cpu")
    torch.testing.assert_close(loss_c.cpu(), loss, **_recsys_tol())
    for a, b, old in zip(tree.leaves(new_c), tree.leaves(new),
                         tree.leaves(params), strict=True):
        d_card, d_cpu = a.cpu() - old, b - old
        assert torch.linalg.vector_norm(d_card - d_cpu) <= \
            1e-3 * torch.linalg.vector_norm(d_cpu) + 1e-12


def test_flash_attention_on_card_vs_cpu(gen):
    """Forward and the FlashAttention-2 backward, GQA and causal, with the
    chunk skip: float32 on the card against the CPU (the reference's
    tolerances, tests/test_attention.py)."""
    from repro_torch.models.attention import flash_attention
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 512, 8, 32, generator=g)
    k = torch.randn(2, 512, 4, 32, generator=g)
    v = torch.randn(2, 512, 4, 32, generator=g)
    dout = torch.randn(2, 512, 8, 32, generator=g)
    outs = []
    for dev in ("cpu", "cuda"):
        leaves = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = flash_attention(*leaves, q_chunk=128, kv_chunk=128)
        grads = torch.autograd.grad(out, leaves, dout.to(dev))
        outs.append([out.detach().cpu()] + [x.cpu() for x in grads])
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=2e-5)
    for a, b in zip(outs[1][1:], outs[0][1:], strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4)


# -- the flash attention kernel against its plain version -------------------
# (b, t, s, h, kv, dqk, dv, causal, q_start): tests/test_torch_attention.py's
# CASES (GQA, t < s, bidirectional, MLA 48/32, and a 96-row shape that is
# one chunk), then n_rep 7 and 8, an explicit q_start, and q_start < 0,
# where the first rows see no key (each is the mean of v, and its backward
# p is 1 on every key); then n_rep 6 at d 128, and a T and an S that no
# tile divides (TMA zero-fills past both; keys past S still read -inf)
ATTN_CASES = [
    (2, 1024, 1024, 4, 2, 64, 64, True, None),
    (1, 512, 2048, 8, 8, 32, 32, True, None),
    (2, 1024, 1024, 6, 3, 64, 64, False, None),
    (2, 512, 512, 4, 4, 48, 32, True, None),
    (2, 96, 96, 4, 2, 16, 16, True, None),
    (1, 512, 512, 7, 1, 64, 64, True, None),
    (2, 256, 256, 8, 1, 128, 128, True, None),
    (1, 512, 1024, 4, 2, 32, 32, True, 256),
    (2, 256, 256, 4, 2, 64, 64, True, -100),
    (1, 512, 512, 12, 2, 128, 128, True, None),
    (2, 160, 200, 6, 2, 128, 128, True, None),
    (1, 100, 200, 4, 2, 64, 64, False, None),
]
# float32 only, against the CUDA-core route's tiles (128 query rows with 64
# or 48 keys a forward step and 32 or 16 a dq step, 128 keys a dk/dv block
# with 32 or 16 rows a step): T and S off every tile size, each bucket
# (32/32 and 48/32 zero-padded onto 64/64), n_rep 1, 2, 6 and 7, rows
# before key 0, a context-parallel q_start, and MLA's split v; (case, v a
# split view)
ATTN_F32_CASES = [
    ((1, 200, 264, 6, 1, 32, 32, True, None), False),
    ((2, 130, 130, 7, 1, 48, 32, True, -30), False),
    ((2, 257, 257, 4, 2, 64, 64, False, None), False),
    ((1, 300, 1100, 4, 2, 128, 128, True, 700), False),
    ((1, 129, 190, 12, 2, 128, 128, True, -5), False),
    ((1, 330, 330, 2, 2, 192, 128, True, None), True),
    ((2, 100, 300, 4, 4, 192, 128, True, 150), True),
]
# float32: the reference's own tolerances (tests/test_torch_attention.py),
# output and lse atol 2e-5, gradients 5e-4, rtol 0; bf16: relative L2 2e-2
# (LM_ATTN_REL_L2 in chip_smoke.py; the plain version rounds q.k, dO.v and
# each chunk pair's products to bf16, the kernel keeps them in f32)
ATTN_REL_L2 = 2e-2


def _attn_inputs(gen, b, t, s, h, kv, dqk, dv, dtype, split_v=False):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, k = rnd(b, t, h, dqk), rnd(b, s, kv, dqk)
    if split_v:       # MLA: v is a split view of the up-projected kv
        v = rnd(b, s, kv, 128 + dv).split([128, dv], -1)[1]
    else:
        v = rnd(b, s, kv, dv)
    return q, k, v, rnd(b, t, h, dv)


def _attn_close(got, want, dtype, atol):
    for a, w in zip(got, want, strict=True):
        assert a.dtype == w.dtype and a.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, rtol=0, atol=atol)
        else:
            assert bool(torch.isfinite(a.float()).all())
            assert float(torch.linalg.vector_norm((a - w).float())) <= \
                ATTN_REL_L2 * float(torch.linalg.vector_norm(w.float()))


def _attn_vs_plain(gen, b, t, s, h, kv, dqk, dv, causal, q_start, dtype,
                   split_v=False):
    """The kernel against its plain version, through the route its dtype
    takes (bf16: wgmma, float32: the CUDA cores), counted on that route."""
    from repro_torch.kernels.flash_attention import (BWD_LAUNCHES, bucket,
                                                     flash_attention_bwd,
                                                     flash_attention_fwd,
                                                     route)
    q, k, v, dout = _attn_inputs(gen, b, t, s, h, kv, dqk, dv, dtype,
                                 split_v)
    # the plain version's chunks: 256, or the whole length where 256 does
    # not divide it
    qc, kc = (256 if n % 256 == 0 else n for n in (t, s))
    args = (s - t if q_start is None else q_start, causal, qc, kc,
            dqk ** -0.5)
    way = route(dtype, bucket(dqk, dv))[0]
    assert way == ("wgmma" if dtype == torch.bfloat16 else "cuda_cores")
    f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    rf0, rb0 = (dict(flash_attention_fwd.routes),
                dict(flash_attention_bwd.routes))
    out, lse = flash_attention_fwd(q, k, v, *args)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, *args)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == \
        (f0 + 1, b0 + BWD_LAUNCHES[way])
    assert flash_attention_fwd.routes == {**rf0, way: rf0[way] + 1}
    assert flash_attention_bwd.routes == \
        {**rb0, way: rb0[way] + BWD_LAUNCHES[way]}
    want_out, want_lse = ops.attn_fwd_ref(q, k, v, *args)
    want_grads = ops.attn_bwd_ref(q, k, v, want_out, want_lse, dout, *args)
    _attn_close([out], [want_out], dtype, 2e-5)
    torch.testing.assert_close(lse, want_lse, rtol=0,
                               atol=2e-5 if dtype == torch.float32 else 2e-2)
    _attn_close(grads, want_grads, dtype, 5e-4)


class TestFlashAttentionKernel:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("case", ATTN_CASES)
    def test_vs_plain(self, gen, case, dtype):
        _attn_vs_plain(gen, *case, dtype)

    @pytest.mark.parametrize("case,split_v", ATTN_F32_CASES)
    def test_f32_vs_plain_off_the_tiles(self, gen, case, split_v):
        _attn_vs_plain(gen, *case, torch.float32, split_v=split_v)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_mla_192_128_split_v(self, gen, dtype):
        """deepseek-v3's head dims, n_rep 1, v a split view whose row
        stride is not its dim."""
        _attn_vs_plain(gen, 1, 256, 256, 4, 4, 192, 128, True, None, dtype,
                       split_v=True)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_backward_is_deterministic(self, gen, dtype):
        """No atomics: two calls give the same bits, forward and backward
        (the lm_mesh phase's (1, 1) plans rely on it)."""
        from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                         flash_attention_fwd)
        q, k, v, dout = _attn_inputs(gen, 2, 512, 512, 8, 2, 64, 64, dtype)
        args = (0, True, 256, 256, 0.125)
        out, lse = flash_attention_fwd(q, k, v, *args)
        again = flash_attention_fwd(q, k, v, *args)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        first = flash_attention_bwd(q, k, v, out, lse, dout, *args)
        second = flash_attention_bwd(q, k, v, out, lse, dout, *args)
        assert all(torch.equal(a, b)
                   for a, b in zip(first, second, strict=True))

    def test_rows_that_see_no_key_are_the_mean_of_v(self, gen):
        from repro_torch.kernels.flash_attention import flash_attention_fwd
        q, k, v, _ = _attn_inputs(gen, 1, 128, 128, 2, 2, 32, 32,
                                  torch.float32)
        out, _ = flash_attention_fwd(q, k, v, -64, True, 128, 128, 32 ** -0.5)
        torch.testing.assert_close(
            out[:, :64], v.mean(1, keepdim=True).expand(1, 64, 2, 32),
            rtol=0, atol=2e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_function_counts_and_raises(self, gen, dtype):
        """One forward and two backward launches a call on either route
        (float32 on the CUDA cores, bf16 on wgmma)."""
        from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                         flash_attention_fwd)
        from repro_torch.models.attention import flash_attention
        way = "cuda_cores" if dtype == torch.float32 else "wgmma"
        q, k, v, dout = _attn_inputs(gen, 1, 256, 256, 4, 2, 64, 64, dtype)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
        r0 = flash_attention_bwd.routes[way]
        out = flash_attention(q, k, v, q_chunk=128, kv_chunk=128)
        torch.autograd.grad(out, (q, k, v), dout)
        assert (flash_attention_fwd.launches,
                flash_attention_bwd.launches) == (f0 + 1, b0 + 2)
        assert flash_attention_bwd.routes[way] == r0 + 2
        for dqk, dv in ((256, 64), (64, 256), (12, 12)):
            a, b_, c, _ = _attn_inputs(gen, 1, 64, 64, 2, 2, dqk, dv,
                                       torch.float32)
            with pytest.raises(ValueError):
                flash_attention_fwd(a, b_, c, 0, True, 64, 64, 0.1)
        with pytest.raises(ValueError):           # last dim not contiguous
            flash_attention_fwd(q.detach().transpose(2, 3).contiguous()
                                .transpose(2, 3), k.detach(), v.detach(),
                                0, True, 128, 128, 0.1)
        other = torch.bfloat16 if dtype == torch.float32 else torch.float32
        with pytest.raises(TypeError):            # mixed dtypes
            flash_attention_fwd(q.detach().to(other), k.detach(), v.detach(),
                                0, True, 128, 128, 0.1)
        assert (flash_attention_fwd.launches,
                flash_attention_bwd.launches) == (f0 + 1, b0 + 2)


# -- the LM's mesh branches at world size 1 over NCCL -----------------------


@pytest.mark.parametrize("ep_2d", [False, True])
def test_lm_mesh_prefill_and_decode_vs_mesh_free(gen, nccl_mesh, ep_2d):
    """The reduced qwen3-moe with expert parallelism (sharded, or the 2D
    serving layout) and Megatron TP under a (1, 1) NCCL mesh: prefill's
    logits and cache and one decode step's logits equal the mesh-free
    calls', and the MoE's collectives ran."""
    from repro_torch.configs.lm_common import lm_param_rules, serve_rules_2d
    from repro_torch.distributed.shardings import make_param_specs
    from repro_torch.models import lm
    from repro_torch.models.moe import MoEConfig
    cfg = _lm_small(qk_norm=True, ep_axis="model", ep_2d=ep_2d,
                    batch_axes=("data",),
                    moe=MoEConfig(d_model=64, d_expert=32, n_experts=8,
                                  top_k=2, capacity_factor=2.0))
    params = _on_card(lm.init(0, cfg, device="cpu"))
    specs = make_param_specs(params, serve_rules_2d(cfg) if ep_2d
                             else lm_param_rules(cfg))
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen,
                         device="cuda")
    grow = lambda c: {k: torch.nn.functional.pad(  # noqa: E731
        v, [0, 0] * (v.ndim - 3) + [0, 1]) for k, v in c.items()}
    nccl_mesh.calls.clear()
    with torch.inference_mode():
        got, cache = lm.prefill(params, toks[:, :64], cfg, nccl_mesh, specs)
        want, wcache = lm.prefill(params, toks[:, :64], cfg)
        torch.testing.assert_close(got, want, **_recsys_tol())
        for k in cache:
            torch.testing.assert_close(cache[k], wcache[k], **_recsys_tol())
        got, _ = lm.decode_step(params, grow(cache), toks[:, 64], 64, cfg,
                                nccl_mesh, specs)
        want, _ = lm.decode_step(params, grow(wcache), toks[:, 64], 64, cfg)
    torch.testing.assert_close(got, want, **_recsys_tol())
    assert nccl_mesh.calls["all_reduce"] >= 2 * cfg.n_layers
    if ep_2d:
        assert nccl_mesh.calls["all_gather"] >= 2 * cfg.n_layers


def test_lm_mesh_cp_train_step_vs_mesh_free(gen, nccl_mesh):
    """The reduced qwen2 with context-parallel attention and sequence
    sharding: one step of its train plan (forward, backward, AdamW) under a
    (1, 1) NCCL mesh against the same plan without a mesh: the loss, every
    gradient and every updated param."""
    import dataclasses

    from repro_torch import configs, tree
    from repro_torch.configs import lm_common
    from repro_torch.models import lm
    cfg = _lm_small(n_kv_heads=1, qkv_bias=True, tie_embeddings=True,
                    context_parallel=True)
    bundle = dataclasses.replace(configs.get_arch("qwen2-0.5b"), cfg=cfg)
    params = _on_card(lm.init(0, cfg, device="cpu"))
    toks = torch.randint(0, cfg.vocab, (2, 2, 65), generator=gen,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": toks[..., :-1], "targets": toks[..., 1:]}
    plans = [lm_common.build_train_plan(bundle, m, False, microbatch=2,
                                        seq_shard=True)
             for m in (nccl_mesh, None)]
    (loss, grads), (wloss, wgrads) = [p.grads(params, batch) for p in plans]
    torch.testing.assert_close(loss, wloss, **_recsys_tol())
    for a, b in zip(tree.leaves(grads), tree.leaves(wgrads), strict=True):
        torch.testing.assert_close(a, b, **_recsys_tol())
    opt = bundle.optimizer
    (new, _, _), (wnew, _, _) = [p.fn(params, opt.init(params), batch)
                                 for p in plans]
    for a, b in zip(tree.leaves(new), tree.leaves(wnew), strict=True):
        torch.testing.assert_close(a, b, **_recsys_tol())


def _recsys_batch(like: dict, n_items: int, seq_len: int, gen) -> dict:
    """Random inputs on the card of a recsys plan's batch of meta tensors:
    ids in the item range (``mask_pos`` in the sequence), masks, labels
    and profiles."""
    out = {}
    for k, x in like.items():
        shape = tuple(x.shape)
        if x.dtype == torch.bool:
            out[k] = torch.rand(shape, generator=gen, device="cuda") < 0.8
        elif not x.is_floating_point():
            hi = seq_len if k == "mask_pos" else n_items
            out[k] = torch.randint(0, hi, shape, generator=gen,
                                   device="cuda", dtype=x.dtype)
        elif k == "labels":
            out[k] = (torch.rand(shape, generator=gen, device="cuda")
                      < 0.4).float()
        else:
            out[k] = torch.randn(shape, generator=gen, device="cuda")
    return out


@pytest.mark.parametrize("arch", ["din", "bert4rec"])
def test_item_sharded_plans_vs_mesh_free(gen, nccl_mesh, monkeypatch, arch):
    """DIN's and BERT4Rec's registry plans at narrow width under a (1, 1)
    NCCL mesh (the item table's row block, the masked lookups summed over
    ``model``, BERT4Rec's sharded logsumexp and score gather, run at one
    rank) against the same plans without a mesh: every serve cell's
    output, and the train cell's loss, gradients, updated params and
    optimizer state."""
    from repro_torch import configs, tree
    from repro_torch.configs import bert4rec_arch, din_arch, recsys_common
    from repro_torch.models import bert4rec, din
    if arch == "din":
        cfg = din.DINConfig(n_items=4000, seq_len=20)
        monkeypatch.setattr(din_arch, "CONFIG", cfg)
    else:
        cfg = bert4rec.Bert4RecConfig(n_items=1024, seq_len=24)
        monkeypatch.setattr(bert4rec_arch, "CONFIG", cfg)
    for cell, shp in {"train_batch": dict(batch=64),
                      "serve_p99": dict(batch=32),
                      "serve_bulk": dict(batch=128),
                      "retrieval_cand": dict(batch=1, n_candidates=500)
                      }.items():
        monkeypatch.setitem(recsys_common.RECSYS_SHAPES, cell, shp)
    bundle = configs.get_arch(arch)
    params = _on_card(bundle.init(0, device="cpu"))
    for cell, step in bundle.steps.items():
        plans = [step.make_fn(bundle, m, False) for m in (nccl_mesh, None)]
        batch = _recsys_batch(plans[1].args[-1], cfg.n_items, cfg.seq_len,
                              gen)
        nccl_mesh.calls.clear()
        if step.kind == "serve":
            with torch.inference_mode():
                got, want = [p.fn(params, batch) for p in plans]
            torch.testing.assert_close(got, want, **_recsys_tol())
        else:
            # BERT4Rec's mesh loss is the sharded logsumexp less the
            # target's logit where the mesh-free one is log_softmax: other
            # roundings, held at the f32 gradient tolerance of the 8-rank
            # tests (tests/test_torch_registry_mesh.py)
            tol = dict(rtol=1e-4, atol=1e-4)
            (loss, grads), (wloss, wgrads) = [p.grads(params, batch)
                                              for p in plans]
            torch.testing.assert_close(loss, wloss, **_recsys_tol())
            for a, b in zip(tree.leaves(grads), tree.leaves(wgrads),
                            strict=True):
                torch.testing.assert_close(a, b, **tol)
            # the step from a state far from zero moments: AdamW's first
            # step from them is sign(g), which rounding flips
            state = tree.tree_map(
                lambda x: torch.rand(x.shape, generator=gen, device="cuda")
                + 0.5 if x.is_floating_point() else x,
                bundle.optimizer.init(params))
            got, want = [p.fn(params, state, batch) for p in plans]
            for a, b in zip(tree.leaves(got[:2]), tree.leaves(want[:2]),
                            strict=True):
                torch.testing.assert_close(a, b, **tol)
        assert nccl_mesh.calls["all_reduce"] >= 1, cell
