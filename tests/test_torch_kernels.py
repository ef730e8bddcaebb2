"""The port's kernel ops against the JAX reference's Pallas kernels.

On the CPU the port's wrappers run their kernels' plain versions; here they
are held against the Pallas kernels in interpret mode, case for case with
``tests/test_kernels.py``. Also: the remap layout and the plain embedding
bag against the reference's. Inputs are made with numpy from a seed and
handed to both packages; JAX stays on the CPU.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.embedding import bag as jax_bag
from repro.embedding import layout as jax_layout
from repro.kernels import ops as jax_ops
from repro.kernels.dot_interaction import dot_interaction as jax_dot
from repro.kernels.recflash_sls import recflash_sls as jax_sls
from repro.models.dlrm import interact as jax_interact
from repro_torch.embedding import bag, layout
from repro_torch.kernels import ops
from repro_torch.kernels.dot_interaction import (dot_interaction,
                                                 dot_interaction_fused)
from repro_torch.kernels import recflash_sls as sls_mod
from repro_torch.kernels.recflash_sls import (describe, recflash_sls,
                                              recflash_sls_grouped)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _sls_inputs(h, v, d, b, lk, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    hot = rng.standard_normal((h, d)).astype(np.float32)
    cold = rng.standard_normal((v - h, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, lk)).astype(np.int32)
    (jh, th), (jc, tc) = _both(hot, dtype), _both(cold, dtype)
    return (jh, jc, jnp.asarray(idx)), (th, tc, torch.from_numpy(idx))


class TestRecFlashSLS:
    # the Pallas kernel accumulates each bag sequentially, the plain version
    # reduces it in torch's order: f32 sums of L terms differ by O(L*eps),
    # so f32 holds to rtol 1e-5 / atol 1e-6 (tests/test_kernels.py); bf16
    # tables are rounded identically on both sides and widened before the
    # sum, and keep the reference's 2e-2, which also covers the port's one
    # rounding of the f32 sum to a bf16 bag (the Pallas kernel returns f32)
    @pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                            ("bfloat16", 2e-2)])
    @pytest.mark.parametrize("h,v,d,b,lk", [
        (32, 128, 8, 16, 4),
        (64, 512, 16, 32, 20),
        (16, 64, 32, 8, 1),       # single lookup per bag
        (128, 130, 64, 8, 7),     # nearly-all-hot table
    ])
    def test_shapes_vs_reference(self, h, v, d, b, lk, dtype, rtol):
        j, t = _sls_inputs(h, v, d, b, lk, dtype)
        want = jax_sls(*j, block_b=8, interpret=True)
        got = recflash_sls(*t, block_b=8)
        assert got.dtype == DTYPES[dtype][1] and got.shape == (b, d)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                                   rtol=rtol, atol=1e-6)

    def test_all_hot_and_all_cold_paths(self):
        j, t = _sls_inputs(32, 64, 8, 8, 4)
        for fill in (0, 40):                      # hot row 0; a cold row
            ji = jnp.full((8, 4), fill, jnp.int32)
            ti = torch.full((8, 4), fill, dtype=torch.int32)
            want = jax_sls(j[0], j[1], ji, block_b=8, interpret=True)
            np.testing.assert_allclose(recflash_sls(t[0], t[1], ti).numpy(),
                                       np.asarray(want), rtol=1e-6)

    def test_block_b_must_divide(self):
        j, t = _sls_inputs(32, 64, 8, 10, 4)
        with pytest.raises(ValueError):
            jax_sls(*j, block_b=8, interpret=True)
        with pytest.raises(ValueError):
            recflash_sls(*t, block_b=8)

    def test_public_op_vs_reference_op(self):
        j, t = _sls_inputs(32, 128, 8, 16, 4)
        np.testing.assert_allclose(ops.recflash_sls(*t).numpy(),
                                   np.asarray(jax_ops.recflash_sls(*j)),
                                   rtol=1e-5, atol=1e-6)

    def test_rejects_what_the_kernel_does_not_take(self):
        _, (hot, cold, idx) = _sls_inputs(32, 64, 8, 8, 4)
        before = recflash_sls.launches
        with pytest.raises(TypeError):
            recflash_sls(hot, cold, idx.long())
        with pytest.raises(TypeError):
            recflash_sls(hot, cold.double(), idx)
        with pytest.raises(ValueError):
            recflash_sls(hot, cold[:, :4], idx)
        recflash_sls(hot, cold, idx)              # CPU: the plain version
        assert recflash_sls.launches == before    # counts kernel launches only


def _group_inputs(rows, hot_sizes, d, b, lk, dtype="float32", remap=True,
                  seed=0):
    """Stored tables, rank_of hash tables and (B, n_tables, L) logical ids
    for both packages; rank_of is None on both sides without ``remap``."""
    rng = np.random.default_rng(seed)
    jt, tt, jr, tr, ids = [], [], [], [], []
    for v in rows:
        j, t = _both(rng.standard_normal((v, d)).astype(np.float32), dtype)
        jt.append(j)
        tt.append(t)
        r = rng.permutation(v).astype(np.int32)
        jr.append(jnp.asarray(r))
        tr.append(torch.from_numpy(r))
        ids.append(rng.integers(0, v, (b, lk)))
    idx = np.stack(ids, axis=1).astype(np.int32)
    return ((jt, jr if remap else None, jnp.asarray(idx)),
            (tt, tr if remap else None, torch.from_numpy(idx)))


class TestRecFlashSLSGrouped:
    # the reference: the Pallas kernel in interpret mode, table by table,
    # after jnp.take(rank_of) (src/repro/models/dlrm.py:124); tolerances as
    # for the per-table kernel
    @pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                            ("bfloat16", 2e-2)])
    @pytest.mark.parametrize("remap", [True, False])
    @pytest.mark.parametrize("rows,hot_sizes,d,lk", [
        ((64, 100, 130), (1, 17, 129), 16, 5),
        ((128, 128), (64, 2), 8, 20),
        ((50,), (10,), 32, 1),
    ])
    def test_vs_reference_per_table(self, rows, hot_sizes, d, lk, remap,
                                    dtype, rtol):
        (jt, jr, ji), (tt, tr, ti) = _group_inputs(rows, hot_sizes, d, 8, lk,
                                                   dtype, remap)
        got = recflash_sls_grouped(tt, hot_sizes, ti, tr)
        assert got.dtype == DTYPES[dtype][1] and got.shape == (8, len(rows),
                                                               d)
        for t, h in enumerate(hot_sizes):
            ranks = ji[:, t, :] if jr is None else jnp.take(jr[t],
                                                            ji[:, t, :])
            want = jax_sls(jt[t][:h], jt[t][h:], ranks, block_b=8,
                           interpret=True)
            np.testing.assert_allclose(got[:, t].float().numpy(),
                                       np.asarray(want), rtol=rtol, atol=1e-6)

    def test_strided_indices(self):
        _, (tt, tr, ti) = _group_inputs((64, 100), (3, 50), 16, 8, 6)
        strided = ti.permute(0, 2, 1).contiguous().permute(0, 2, 1)
        assert not strided.is_contiguous()
        np.testing.assert_array_equal(
            recflash_sls_grouped(tt, (3, 50), strided, tr).numpy(),
            recflash_sls_grouped(tt, (3, 50), ti, tr).numpy())

    def test_descriptors_are_checked(self):
        _, (tt, tr, ti) = _group_inputs((64, 100), (3, 50), 16, 8, 6)
        desc = describe(tt, (3, 50), tr)
        assert desc.tensor.shape == (2, 6) and desc.tensor.dtype == \
            torch.int64
        assert desc.tensor[:, 3:].tolist() == [[3, 64, 64], [50, 100, 100]]
        assert desc.tensor[1, 2] == tr[1].data_ptr()
        recflash_sls_grouped(tt, (3, 50), ti, tr, desc)
        for tables, hot, rank_of in (([tt[0].clone(), tt[1]], (3, 50), tr),
                                     (tt, (4, 50), tr),
                                     (tt, (3, 50), [tr[0].clone(), tr[1]]),
                                     (tt, (3, 50), None)):
            with pytest.raises(ValueError):
                recflash_sls_grouped(tables, hot, ti, rank_of, desc)

    def test_rejects_what_the_kernel_does_not_take(self):
        _, (tt, tr, ti) = _group_inputs((64, 100), (3, 50), 16, 8, 6)
        before = recflash_sls_grouped.launches
        with pytest.raises(TypeError):
            recflash_sls_grouped(tt, (3, 50), ti.long(), tr)
        with pytest.raises(TypeError):
            recflash_sls_grouped(tt, (3, 50), ti[:, :1], tr)
        with pytest.raises(TypeError):
            recflash_sls_grouped(tt, (3, 50), ti, [r.long() for r in tr])
        with pytest.raises(ValueError):
            recflash_sls_grouped([tt[0], tt[1][:, :8]], (3, 50), ti, tr)
        with pytest.raises(ValueError):
            recflash_sls_grouped(tt, (0, 50), ti, tr)
        with pytest.raises(ValueError):
            recflash_sls_grouped(tt, (3,), ti, tr)
        recflash_sls_grouped(tt, (3, 50), ti, tr)  # CPU: the plain version
        assert recflash_sls_grouped.launches == before

    @pytest.mark.parametrize("name,value", [
        ("kDepthShort", sls_mod.PIPELINE_DEPTHS[0]),
        ("kDepthLong", sls_mod.PIPELINE_DEPTHS[1]),
        ("kMaxRagged", sls_mod.MAX_RAGGED_TABLES)])
    def test_constants_are_the_kernels(self, name, value):
        src = (Path(sls_mod.__file__).with_name("csrc")
               / "recflash_sls.cu").read_text()
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value

    def test_public_op_is_the_per_table_ops(self):
        _, (tt, tr, ti) = _group_inputs((64, 100), (3, 50), 16, 8, 6)
        got = ops.recflash_sls_grouped(tt, (3, 50), ti, tr)
        for t, h in enumerate((3, 50)):
            ranks = layout.lookup(tr[t], ti[:, t, :])
            np.testing.assert_array_equal(
                got[:, t].numpy(),
                ops.recflash_sls(tt[t][:h], tt[t][h:], ranks).numpy())


class TestDotInteraction:
    # f32 dots over D in two orders (near-zero off-diagonal entries make a
    # pure rtol meaningless, hence atol 1e-5); bf16 keeps the reference's
    # 3e-2
    @pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                           ("bfloat16", 3e-2)])
    @pytest.mark.parametrize("b,t,d", [(64, 9, 16), (128, 27, 64),
                                       (64, 33, 128), (8, 3, 18)])
    def test_shapes_vs_reference(self, b, t, d, dtype, tol):
        z = np.random.default_rng(0).standard_normal((b, t, d)).astype(
            np.float32)
        jz, tz = _both(z, dtype)
        want = jax_dot(jz, block_b=min(64, b), interpret=True)
        got = dot_interaction(tz, block_b=min(64, b))
        assert got.dtype == torch.float32 and got.shape == (b, t, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)

    def test_triangle_extraction(self):
        z = np.random.default_rng(1).standard_normal((16, 5, 8)).astype(
            np.float32)
        jz, tz = _both(z, "float32")
        flat = ops.dot_interaction(tz)
        assert flat.shape == (16, 10)             # 5C2
        np.testing.assert_allclose(flat.numpy(),
                                   np.asarray(jax_ops.dot_interaction(jz)),
                                   rtol=1e-5, atol=1e-5)
        iu, ju = np.triu_indices(27, k=1)
        tiu, tju = torch.triu_indices(27, 27, 1)
        np.testing.assert_array_equal(tiu.numpy(), iu)
        np.testing.assert_array_equal(tju.numpy(), ju)

    def test_block_b_must_divide(self):
        with pytest.raises(ValueError):
            dot_interaction(torch.zeros(10, 3, 4), block_b=4)


class TestDotInteractionFused:
    # against the reference's dlrm.interact (cat, einsum, triangle, cat);
    # tolerances of the Gram kernel
    @pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                           ("bfloat16", 3e-2)])
    @pytest.mark.parametrize("b,t,d", [(64, 9, 16), (128, 27, 64),
                                       (64, 33, 128), (8, 3, 18)])
    def test_vs_reference_interact(self, b, t, d, dtype, tol):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((b, d)).astype(np.float32)
        bags = rng.standard_normal((b, t - 1, d)).astype(np.float32)
        (jx, tx), (jb, tb) = _both(x, dtype), _both(bags, dtype)
        want = jax_interact(jx, jb, "dot")
        got = dot_interaction_fused(tx, tb)
        assert got.dtype == DTYPES[dtype][1]      # the reference's dtype
        assert got.shape == (b, d + t * (t - 1) // 2) == want.shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)

    def test_public_op_and_rejects(self):
        x, bags = torch.randn(4, 8), torch.randn(4, 5, 8)
        before = dot_interaction_fused.launches
        np.testing.assert_array_equal(
            ops.dot_interaction_fused(x, bags).numpy(),
            torch.cat([x, ops.dot_interaction(torch.cat([x[:, None], bags],
                                                        1))], 1).numpy())
        with pytest.raises(ValueError):
            dot_interaction_fused(x, bags[:, :, :4])
        with pytest.raises(TypeError):
            dot_interaction_fused(x, bags.double())
        with pytest.raises(TypeError):
            dot_interaction_fused(x.long(), bags.long())
        assert dot_interaction_fused.launches == before


class TestRemapLayout:
    @pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
    @pytest.mark.parametrize("plane_distribute", [True, False])
    @pytest.mark.parametrize("hot_size", [None, 37])
    def test_spec_matches_reference(self, n_shards, plane_distribute,
                                    hot_size):
        # v = 1001 does not divide by 2, 3 or 4: the overflow fold runs
        counts = np.random.default_rng(3).integers(0, 40, size=1001)
        kw = dict(hot_frac=0.01, n_shards=n_shards,
                  plane_distribute=plane_distribute, hot_size=hot_size)
        got = layout.RemapSpec.from_counts(counts, **kw)
        want = jax_layout.RemapSpec.from_counts(counts, **kw)
        np.testing.assert_array_equal(got.perm, want.perm)
        np.testing.assert_array_equal(got.rank_of, want.rank_of)
        assert (got.hot_size, got.n_shards) == (want.hot_size, want.n_shards)

    def test_identity(self):
        got, want = layout.RemapSpec.identity(9), \
            jax_layout.RemapSpec.identity(9)
        np.testing.assert_array_equal(got.perm, want.perm)
        assert got.hot_size == want.hot_size == 1

    def test_gathers_are_bit_equal(self):
        rng = np.random.default_rng(4)
        table = rng.standard_normal((300, 8)).astype(np.float32)
        spec = layout.RemapSpec.from_counts(rng.integers(0, 9, size=300))
        jspec = jax_layout.RemapSpec(spec.perm, spec.rank_of, spec.hot_size)
        idx = rng.integers(0, 300, (6, 5)).astype(np.int32)
        t_table, t_idx = torch.from_numpy(table), torch.from_numpy(idx)
        stored = layout.remap_table(t_table, spec)
        j_stored = jax_layout.remap_table(jnp.asarray(table), jspec)
        np.testing.assert_array_equal(stored.numpy(), np.asarray(j_stored))
        np.testing.assert_array_equal(
            layout.translate(t_idx, spec).numpy(),
            np.asarray(jax_layout.translate(jnp.asarray(idx), jspec)))
        rank_of = torch.from_numpy(spec.rank_of)
        np.testing.assert_array_equal(
            layout.lookup_remapped(stored, rank_of, t_idx).numpy(),
            np.asarray(jax_layout.lookup_remapped(
                j_stored, jnp.asarray(spec.rank_of), jnp.asarray(idx))))
        np.testing.assert_array_equal(
            layout.lookup_remapped(stored, rank_of, t_idx).numpy(),
            table[idx])


class TestEmbeddingBagDense:
    @pytest.mark.parametrize("mode", ["sum", "mean", "max"])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_matches_reference(self, mode, weighted):
        rng = np.random.default_rng(5)
        table = rng.standard_normal((50, 6)).astype(np.float32)
        idx = rng.integers(0, 50, (4, 3, 7)).astype(np.int32)
        w = rng.random((4, 3, 7)).astype(np.float32) if weighted else None
        got = bag.embedding_bag_dense(
            torch.from_numpy(table), torch.from_numpy(idx), mode,
            None if w is None else torch.from_numpy(w))
        want = jax_bag.embedding_bag_dense(
            jnp.asarray(table), jnp.asarray(idx), mode,
            None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)

    def test_unknown_mode(self):
        with pytest.raises(ValueError):
            bag.embedding_bag_dense(torch.zeros(3, 2),
                                    torch.zeros(1, 1, dtype=torch.int32),
                                    "median")


class TestEmbeddingBagRagged:
    # one f32 sum (or mean, or max) per segment in two orders: the
    # reference's dense-bag tolerance
    TOL = dict(rtol=1e-6, atol=1e-6)
    # 7 bags over 11 ids: bags 1, 4 and 6 are empty (a repeated offset, a
    # repeated offset, and an offset at the end)
    OFFSETS = np.array([0, 3, 3, 6, 9, 9, 11], np.int32)

    @pytest.mark.parametrize("mode", ["sum", "mean", "max"])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_matches_reference(self, mode, weighted):
        rng = np.random.default_rng(8)
        table = rng.standard_normal((40, 5)).astype(np.float32)
        idx = rng.integers(0, 40, 11).astype(np.int32)
        w = rng.random(11).astype(np.float32) if weighted else None
        seg = jax_bag.offsets_to_segment_ids(jnp.asarray(self.OFFSETS), 11)
        want = np.asarray(jax_bag.embedding_bag_ragged(
            jnp.asarray(table), jnp.asarray(idx), seg, 7, mode,
            None if w is None else jnp.asarray(w)))
        t_seg = bag.offsets_to_segment_ids(torch.from_numpy(self.OFFSETS), 11)
        np.testing.assert_array_equal(t_seg.numpy(), np.asarray(seg))
        got = bag.embedding_bag_ragged(
            torch.from_numpy(table), torch.from_numpy(idx), t_seg, 7, mode,
            None if w is None else torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, **self.TOL)
        empty = want[[1, 4, 6]]
        assert (empty == (-np.inf if mode == "max" else 0.0)).all()
        np.testing.assert_array_equal(got[[1, 4, 6]], empty)

    def test_offsets_accumulate_repeats(self):
        for offsets, total in (([0, 3, 4], 6), ([0, 0, 0, 2], 4),
                               ([0, 2, 2, 5, 5], 5), ([0], 3)):
            want = jax_bag.offsets_to_segment_ids(
                jnp.asarray(offsets, jnp.int32), total)
            got = bag.offsets_to_segment_ids(
                torch.tensor(offsets, dtype=torch.int32), total)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_unknown_mode(self):
        with pytest.raises(ValueError):
            bag.embedding_bag_ragged(torch.zeros(3, 2),
                                     torch.zeros(1, dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int32), 1,
                                     "median")


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
