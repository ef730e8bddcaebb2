"""The port's data modules against the reference's, on the CPU.

``repro_torch.data.criteo`` (the Criteo day streams) and
``repro_torch.data.sampler`` (GraphSAGE's neighbour sampler) are numpy
copies, so for the same seed every array they give equals the reference's
exactly. The reference's own checks of both (``tests/test_data.py``) are
mirrored on the port.
"""

import numpy as np
import pytest

from repro.data import criteo as jax_criteo
from repro.data import sampler as jax_sampler
from repro_torch.data import criteo, sampler
from repro_torch.data.criteo import (CRITEO_KAGGLE, CRITEO_TB,
                                     CriteoDayStream, CriteoSpec)
from repro_torch.data.sampler import CSRGraph, sample_blocks


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b, strict=True):
            _equal_trees(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


class TestCriteoParity:
    @pytest.mark.parametrize("spec", [
        dict(name="t", n_days=3, rows_per_field=10_000),
        dict(name="t", n_days=3, rows_per_field=5_000, drift_frac=0.2,
             zipf_alpha=1.05),
        dict(name="t", n_days=2, rows_per_field=3_000, n_fields=8)])
    @pytest.mark.parametrize("seed", [0, 7])
    def test_days_drift_and_counts_equal_the_reference(self, spec, seed):
        """Three days of batches (with lookups_per_field 1 and 3), the
        drifted permutations after each day, and the sampled counts."""
        ref = jax_criteo.CriteoDayStream(jax_criteo.CriteoSpec(**spec), seed)
        got = CriteoDayStream(CriteoSpec(**spec), seed)
        _equal_trees(got.perms, ref.perms)
        np.testing.assert_array_equal(got.probs, ref.probs)
        for day in range(3):
            for lk in (1, 3):
                _equal_trees(got.day_batch(day, 50, lk),
                             ref.day_batch(day, 50, lk))
            got.advance_day()
            ref.advance_day()
            _equal_trees(got.perms, ref.perms)
        _equal_trees(got.sample_training_stats(2_000, seed=3),
                     ref.sample_training_stats(2_000, seed=3))

    def test_specs_equal_the_reference(self):
        for name in ("CRITEO_TB", "CRITEO_KAGGLE"):
            import dataclasses
            assert dataclasses.asdict(getattr(criteo, name)) == \
                dataclasses.asdict(getattr(jax_criteo, name))


class TestCriteoStream:
    """``tests/test_data.py::TestCriteoStream`` on the port."""

    def test_day_batch_shapes(self):
        spec = CriteoSpec("t", n_days=3, rows_per_field=10_000)
        s = CriteoDayStream(spec, seed=0)
        tables, rows, dense = s.day_batch(0, n_samples=100)
        assert tables.shape == rows.shape == (100 * 26,)
        assert dense.shape == (100, 13)
        assert rows.max() < 10_000

    def test_drift_changes_popularity(self):
        spec = CriteoSpec("t", n_days=3, rows_per_field=5_000,
                          drift_frac=0.2)
        s = CriteoDayStream(spec, seed=0)
        before = [p.copy() for p in s.perms]
        s.advance_day()
        changed = sum(int((a != b).sum())
                      for a, b in zip(before, s.perms, strict=True))
        assert changed > 0

    def test_sampled_stats_skewed(self):
        spec = CriteoSpec("t", n_days=2, rows_per_field=5_000)
        s = CriteoDayStream(spec, seed=0)
        counts = s.sample_training_stats(5_000)
        assert counts.shape == (26, 5_000)
        for f in range(3):
            top = np.sort(counts[f])[::-1]
            assert top[:50].sum() > 0.3 * top.sum()

    def test_specs_match_paper(self):
        assert CRITEO_TB.n_days == 24
        assert CRITEO_KAGGLE.n_days == 6
        assert CRITEO_TB.n_fields == 26 and CRITEO_TB.n_dense == 13


class TestSamplerParity:
    @pytest.mark.parametrize("n,deg,fanouts,n_seeds", [
        (200, 6, (5, 3), 32), (100, 5, (4, 3), 16), (500, 12, (15, 10), 64),
        (60, 2, (3,), 60)])
    def test_blocks_equal_the_reference(self, n, deg, fanouts, n_seeds):
        ref_g = jax_sampler.CSRGraph.random(n, avg_degree=deg, d_feat=8,
                                            n_classes=3, seed=4)
        g = CSRGraph.random(n, avg_degree=deg, d_feat=8, n_classes=3, seed=4)
        for field in ("indptr", "indices", "feats", "labels"):
            a, b = getattr(g, field), getattr(ref_g, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        seeds = np.random.default_rng(5).choice(n, n_seeds, replace=False)
        _equal_trees(sample_blocks(g, seeds, fanouts,
                                   np.random.default_rng(1)),
                     jax_sampler.sample_blocks(ref_g, seeds, fanouts,
                                               np.random.default_rng(1)))

    def test_from_edges_equals_the_reference(self):
        rng = np.random.default_rng(0)
        src, dst = rng.integers(0, 30, 90), rng.integers(0, 30, 90)
        feats = rng.normal(size=(30, 4)).astype(np.float32)
        labels = rng.integers(0, 2, 30)
        got = CSRGraph.from_edges(30, src, dst, feats, labels)
        ref = jax_sampler.CSRGraph.from_edges(30, src, dst, feats, labels)
        np.testing.assert_array_equal(got.indptr, ref.indptr)
        np.testing.assert_array_equal(got.indices, ref.indices)
        assert got.n_nodes == ref.n_nodes == 30


class TestNeighborSampler:
    """``tests/test_data.py::TestNeighborSampler`` on the port."""

    def test_blocks_valid_indices(self):
        g = CSRGraph.random(200, avg_degree=6, d_feat=8, n_classes=3)
        blocks = sample_blocks(g, np.arange(32), (5, 3),
                               np.random.default_rng(0))
        assert blocks["feats"].shape[1] == 8
        n0 = blocks["feats"].shape[0]
        assert blocks["nbrs"][0].max() < n0
        assert blocks["self_idx"][0].max() < n0
        assert blocks["self_idx"][1].shape[0] == 32
        assert blocks["labels"].shape == (32,)

    def test_isolated_nodes_masked(self):
        n = 10
        src = np.arange(1, n)
        dst = np.zeros(n - 1, dtype=np.int64)
        g = CSRGraph.from_edges(n, src, dst, np.zeros((n, 4), np.float32),
                                np.zeros(n, np.int64))
        mask = sample_blocks(g, np.arange(n), (3,),
                             np.random.default_rng(0))["mask"][0]
        assert mask[1:].sum() == 0
        assert mask[0].all()

    def test_csr_construction(self):
        g = CSRGraph.from_edges(3, np.array([0, 1, 2]), np.array([1, 2, 0]),
                                np.zeros((3, 2), np.float32),
                                np.zeros(3, np.int64))
        assert g.n_nodes == 3
        nb = g.indices[g.indptr[1]:g.indptr[2]]
        assert list(nb) == [0]


def test_modules_import_no_jax():
    import ast
    import inspect
    for mod in (criteo, sampler):
        tree = ast.parse(inspect.getsource(mod))
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if m.split(".")[0] in ("jax", "repro")]
