"""The port's DLRM against the JAX reference, on the CPU.

The port's forward routes bags through the two-tier SLS op and the
interaction through the Gram op (their plain versions on the CPU); the
reference forward takes ``jnp.take`` bags and an einsum. The same numpy
inputs and transplanted JAX weights go through both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.dlrm as jdlrm
from repro.embedding.layout import RemapSpec as JaxRemapSpec
from repro.embedding.layout import remap_table as jax_remap_table
from repro.launch.train import small_dlrm as jax_small_dlrm
from repro.serving import DeploymentConfig
from repro.serving import arch_model_config as jax_arch_model_config
from repro_torch import configs
from repro_torch.embedding.layout import RemapSpec
from repro_torch.models import dlrm
from repro_torch.weights import from_jax_params

TINY = dict(name="tiny", n_tables=3, n_dense=13, embed_dim=16,
            n_rows=(500,) * 3, lookups=4, bot_mlp=(32, 16), top_mlp=(32,))


def _batch(cfg, b=16, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((b, cfg.n_dense)).astype(np.float32)
    idx = rng.integers(0, cfg.n_rows[0], (b, cfg.n_tables, cfg.lookups)
                       ).astype(np.int32)
    return ({"dense": jnp.asarray(dense), "indices": jnp.asarray(idx)},
            {"dense": torch.from_numpy(dense),
             "indices": torch.from_numpy(idx)})


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


class TestForwardParity:
    # sequential (port plain SLS order) against XLA's bag sums, and the
    # Gram in two orders: O(L*eps) on the bags, carried through the MLPs
    TOL = dict(rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("hot_size", [None, 50, 499])
    def test_remapped_forward(self, hot_size):
        jcfg, tcfg = jdlrm.DLRMConfig(**TINY), configs.DLRMConfig(**TINY)
        params = jdlrm.init(jax.random.PRNGKey(0), jcfg)
        counts = np.random.default_rng(1).integers(0, 30, (3, 500))
        specs = [JaxRemapSpec.from_counts(c, hot_size=hot_size)
                 for c in counts]
        params["tables"] = [jax_remap_table(t, s)
                            for t, s in zip(params["tables"], specs,
                                            strict=True)]
        jb, tb = _batch(jcfg)
        want = jax.jit(lambda p, b: jdlrm.forward(p, b, jcfg))(
            jdlrm.add_remap(params, [s.rank_of for s in specs]), jb)
        tparams = dlrm.add_remap(
            from_jax_params(_np_tree(params), device="cpu"),
            [s.rank_of for s in specs], [s.hot_size for s in specs])
        got = dlrm.forward(tparams, tb, tcfg)
        assert got.shape == (16,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **self.TOL)
        plain = dlrm.forward(tparams, tb, tcfg, plain=True)
        np.testing.assert_allclose(plain.numpy(), got.numpy(), **self.TOL)

    def test_forward_without_remap(self):
        jcfg, tcfg = jdlrm.DLRMConfig(**TINY), configs.DLRMConfig(**TINY)
        params = jdlrm.init(jax.random.PRNGKey(2), jcfg)
        jb, tb = _batch(jcfg, seed=3)
        want = jdlrm.forward(params, jb, jcfg)
        got = dlrm.forward(from_jax_params(_np_tree(params), "cpu"), tb, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **self.TOL)

    def test_transplant_carries_remap_state(self):
        jcfg = jdlrm.DLRMConfig(**TINY)
        params = jdlrm.init(jax.random.PRNGKey(0), jcfg)
        tree = _np_tree(params)
        tree["rank_of"] = [np.arange(500)[::-1]] * 3
        tree["hot_sizes"] = [7, 8, 9]
        got = from_jax_params(tree, device="cpu")
        assert got["hot_sizes"] == [7, 8, 9]
        assert got["rank_of"][0].dtype == torch.int32
        np.testing.assert_array_equal(got["bot"][0]["w"].numpy(),
                                      tree["bot"][0]["w"])
        jbf = {"tables": [t.astype(jnp.bfloat16) for t in params["tables"]],
               "bot": [], "top": []}
        bf = from_jax_params(_np_tree(jbf), "cpu")
        assert bf["tables"][0].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            bf["tables"][0].float().numpy(),
            np.asarray(jbf["tables"][0], np.float32))


class TestRetrievalScore:
    # the forward's tolerance: bag sums and Gram dots in two orders
    TOL = dict(rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("n", [40, 13])
    def test_matches_reference(self, n):
        jcfg, tcfg = jdlrm.DLRMConfig(**TINY), configs.DLRMConfig(**TINY)
        params = jdlrm.init(jax.random.PRNGKey(4), jcfg)
        counts = np.random.default_rng(9).integers(0, 30, (3, 500))
        specs = [JaxRemapSpec.from_counts(c, hot_size=20) for c in counts]
        params["tables"] = [jax_remap_table(t, s)
                            for t, s in zip(params["tables"], specs,
                                            strict=True)]
        rng = np.random.default_rng(10)
        dense = rng.standard_normal((1, 13)).astype(np.float32)
        idx = rng.integers(0, 500, (1, 3, 4)).astype(np.int32)
        cand = rng.integers(0, 500, n).astype(np.int32)
        want = jdlrm.retrieval_score(
            jdlrm.add_remap(params, [s.rank_of for s in specs]),
            {"dense": jnp.asarray(dense), "indices": jnp.asarray(idx),
             "candidates": jnp.asarray(cand)}, jcfg)
        tparams = dlrm.add_remap(
            from_jax_params(_np_tree(params), device="cpu"),
            [s.rank_of for s in specs], [s.hot_size for s in specs])
        tbatch = {"dense": torch.from_numpy(dense),
                  "indices": torch.from_numpy(idx),
                  "candidates": torch.from_numpy(cand)}
        got = dlrm.retrieval_score(tparams, tbatch, tcfg)
        assert got.shape == (n,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **self.TOL)
        np.testing.assert_allclose(
            dlrm.retrieval_score(tparams, tbatch, tcfg, plain=True).numpy(),
            got.numpy(), **self.TOL)


class TestGroupedBags:
    def _params(self, hot_sizes=(5, 50, 499)):
        cfg = configs.DLRMConfig(**TINY)
        params = dlrm.init(0, cfg, device="cpu")
        perms = np.random.default_rng(6).permuted(
            np.tile(np.arange(500), (3, 1)), axis=1)
        return cfg, dlrm.add_remap(params, list(perms), hot_sizes)

    @pytest.mark.parametrize("remap", [True, False])
    def test_bags_equal_the_per_table_path(self, remap):
        cfg, params = self._params()
        if not remap:
            params = {k: params[k] for k in ("tables", "bot", "top")}
        _, tb = _batch(cfg, seed=4)
        got = dlrm.bags(params, tb["indices"])
        assert got.shape == (16, 3, 16) and got.dtype == torch.float32
        for t in range(3):
            np.testing.assert_array_equal(
                got[:, t].numpy(),
                dlrm._bag(params, tb["indices"][:, t, :], t).numpy())
        np.testing.assert_array_equal(
            dlrm.bags(params, tb["indices"], plain=True).numpy(),
            got.numpy())

    def test_add_remap_describes_the_tables_once(self):
        cfg, params = self._params()
        desc = params["sls_desc"]
        assert desc.tensor.shape == (3, 6)
        assert desc.tensor[:, 3].tolist() == [5, 50, 499]
        assert desc.tensor[0, 0] == params["tables"][0].data_ptr()
        assert desc.tensor[0, 2] == params["rank_of"][0].data_ptr()
        _, tb = _batch(cfg, seed=5)
        dlrm.forward(params, tb, cfg)
        params["tables"][2] = params["tables"][2].clone()
        with pytest.raises(ValueError):
            dlrm.forward(params, tb, cfg)
        with pytest.raises(ValueError):
            self._params(hot_sizes=(5, 50, 501))

    def test_interact_is_the_fused_entry(self):
        rng = np.random.default_rng(7)
        x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
        bags = torch.from_numpy(rng.standard_normal((4, 3, 16)).astype(
            np.float32))
        want = jdlrm.interact(jnp.asarray(x.numpy()), jnp.asarray(
            bags.numpy()), "dot")
        for plain in (False, True):
            np.testing.assert_allclose(
                dlrm.interact(x, bags, "dot", plain).numpy(),
                np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            dlrm.interact(x, bags, "cat").numpy(),
            np.asarray(jdlrm.interact(jnp.asarray(x.numpy()),
                                      jnp.asarray(bags.numpy()), "cat")))


class TestInit:
    def test_shapes_and_ranges_match_reference(self):
        for jcfg in (jdlrm.DLRMConfig(**TINY), jdlrm.RMC1):
            tcfg = configs.DLRMConfig(**dataclasses.asdict(jcfg))
            if max(jcfg.n_rows) > 1000:
                jcfg = dataclasses.replace(jcfg, n_rows=(1000,) * jcfg.n_tables)
                tcfg = dataclasses.replace(tcfg, n_rows=(1000,) * tcfg.n_tables)
            want = jax.eval_shape(lambda k, c=jcfg: jdlrm.init(k, c),
                                  jax.random.PRNGKey(0))
            got = dlrm.init(0, tcfg, device="cpu")
            assert jax.tree.map(lambda x: tuple(x.shape), want) == \
                jax.tree.map(lambda x: tuple(x.shape), got)
            for t in got["tables"]:
                assert float(t.abs().max()) <= 1.0 / np.sqrt(t.shape[0])
            assert all(float(layer["b"].abs().max()) == 0.0
                       for layer in got["bot"] + got["top"])

    def test_seeded(self):
        cfg = configs.DLRMConfig(**TINY)
        a, b = dlrm.init(5, cfg, device="cpu"), dlrm.init(5, cfg, device="cpu")
        assert torch.equal(a["tables"][1], b["tables"][1])
        assert torch.equal(a["top"][0]["w"], b["top"][0]["w"])

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError):
            dlrm.init(0, configs.DLRMConfig(**TINY))
        with pytest.raises(RuntimeError):
            from_jax_params({"tables": [], "bot": [], "top": []})


class TestConfigs:
    @pytest.mark.parametrize("arch", ["rmc1", "rmc2", "rmc3", "dlrm_small",
                                      "dlrm-rm2", "dlrm_mlperf"])
    @pytest.mark.parametrize("rows", [None, 4096])
    def test_serving_shape_matches_reference(self, arch, rows):
        want = jax_arch_model_config(DeploymentConfig.from_arch(arch,
                                                                n_rows=rows))
        got = configs.arch_model_config(arch, n_rows=rows)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.top_in == want.top_in
        assert got.flops_per_sample() == want.flops_per_sample()

    def test_registry_shapes_match_reference(self):
        from repro.configs.dlrm_mlperf import CONFIG as MLPERF
        from repro.configs.dlrm_rm2 import CONFIG as RM2
        for got, want in ((configs.DLRM_RM2, RM2),
                          (configs.DLRM_MLPERF, MLPERF),
                          (configs.RMC1, jdlrm.RMC1),
                          (configs.RMC2, jdlrm.RMC2),
                          (configs.RMC3, jdlrm.RMC3),
                          (configs.small_dlrm(), jax_small_dlrm())):
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert configs.DLRM_RM2.top_in == 415

    def test_unknown_arch(self):
        with pytest.raises(KeyError):
            configs.arch_shape("dlrm_huge")


def test_add_remap_checks_the_range_of_wide_rank_of():
    params = dlrm.init(0, configs.DLRMConfig(**TINY), device="cpu")
    wide = np.arange(500, dtype=np.int64)
    wide[7] = 2**31
    with pytest.raises(ValueError, match="int32"):
        dlrm.add_remap(params, [wide] * 3)
    narrow = torch.arange(500, dtype=torch.int32)
    got = dlrm.add_remap(params, [narrow] * 3)
    assert got["rank_of"][0] is narrow        # taken as it is, no copy


def test_add_remap_defaults_to_hot_size_one():
    params = dlrm.init(0, configs.DLRMConfig(**TINY), device="cpu")
    spec = RemapSpec.identity(500)
    got = dlrm.add_remap(params, [spec.rank_of] * 3)
    assert got["hot_sizes"] == [1, 1, 1]
    assert got["rank_of"][2].dtype == torch.int32
    with pytest.raises(ValueError):
        dlrm.add_remap(params, [spec.rank_of] * 3, [1, 2])
