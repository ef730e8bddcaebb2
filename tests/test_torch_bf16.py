"""A bf16 DLRM and the out-of-range contract of the port, on the CPU.

The reference builds dlrm-mlperf in bf16 (``dlrm.init(..., dtype=
jnp.bfloat16)``). The same transplanted bf16 weights and numpy inputs go
through the reference and through both port routes (the kernels' wrappers,
which run their plain versions on a CPU tensor, and ``plain=True``), held at
the reference's bf16 tolerance. Ids out of range are clamped on every
single-device route of the port, where the reference's ``jnp.take`` fills;
the tests pin both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.dlrm as jdlrm
from repro import optim as jax_optim
from repro.embedding.layout import RemapSpec as JaxRemapSpec
from repro.embedding.layout import remap_table as jax_remap_table
from repro_torch import configs, optim, tree
from repro_torch.embedding import bag, layout
from repro_torch.kernels import ops
from repro_torch.models import dlrm
from repro_torch.weights import from_jax_params

TINY = dict(name="tiny", n_tables=3, n_dense=13, embed_dim=16,
            n_rows=(500,) * 3, lookups=4, bot_mlp=(32, 16), top_mlp=(32,))
V = 500
# the reference's bf16 tolerance (tests/test_kernels.py): bf16 keeps 8
# significant bits, and the two packages round the MLPs' and the
# interaction's products and sums at other places
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def _f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def _models(remap: bool, seed: int = 0):
    """The reference's bf16 model (remapped tables and rank_of when
    ``remap``) and its transplant: (reference params, port params)."""
    jcfg = jdlrm.DLRMConfig(**TINY)
    params = jdlrm.init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.bfloat16)
    tree_np = jax.tree.map(np.asarray, params)
    if remap:
        counts = np.random.default_rng(seed + 1).integers(0, 30, (3, V))
        specs = [JaxRemapSpec.from_counts(c, hot_size=h)
                 for c, h in zip(counts, (1, 40, 499), strict=True)]
        params = jdlrm.add_remap(
            {**params, "tables": [jax_remap_table(t, s) for t, s in
                                  zip(params["tables"], specs, strict=True)]},
            [s.rank_of for s in specs])
        tree_np = {**jax.tree.map(np.asarray, {k: params[k] for k in
                                               ("tables", "bot", "top")}),
                   "rank_of": [s.rank_of for s in specs],
                   "hot_sizes": [s.hot_size for s in specs]}
    return params, from_jax_params(tree_np, device="cpu")


def _batch(dense_dtype: str, b: int = 16, seed: int = 3):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((b, 13)).astype(np.float32)
    idx = rng.integers(0, V, (b, 3, 4)).astype(np.int32)
    labels = (rng.random(b) > 0.5).astype(np.float32)
    jd, td = DTYPES[dense_dtype]
    return ({"dense": jnp.asarray(dense).astype(jd),
             "indices": jnp.asarray(idx), "labels": jnp.asarray(labels)},
            {"dense": torch.from_numpy(dense).to(td),
             "indices": torch.from_numpy(idx),
             "labels": torch.from_numpy(labels)})


def _leaves(p):
    """The trainable leaves (tables and MLPs), in the reference's order."""
    return {k: p[k] for k in ("bot", "tables", "top")}


class TestBF16Forward:
    @pytest.mark.parametrize("plain", [False, True])
    @pytest.mark.parametrize("remap", [False, True])
    @pytest.mark.parametrize("dense_dtype", ["bfloat16", "float32"])
    def test_logits_match_reference(self, dense_dtype, remap, plain):
        """bf16 dense features give bf16 logits; float32 ones on bf16
        weights give float32 logits, as JAX promotes them."""
        cfg = configs.DLRMConfig(**TINY)
        jp, tp = _models(remap)
        jb, tb = _batch(dense_dtype)
        want = jdlrm.forward(jp, jb, jdlrm.DLRMConfig(**TINY))
        got = dlrm.forward(tp, tb, cfg, plain=plain)
        assert got.dtype == DTYPES[str(want.dtype)][1]
        np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                   **BF16_TOL)

    @pytest.mark.parametrize("plain", [False, True])
    def test_bags_and_top_mlp_input_are_bf16(self, plain):
        _, tp = _models(remap=True)
        _, tb = _batch("bfloat16")
        bags = dlrm.bags(tp, tb["indices"], plain)
        assert bags.dtype == torch.bfloat16
        x = dlrm.mlp(tp["bot"], tb["dense"])
        feat = dlrm.interact(x, bags, "dot", plain)
        assert x.dtype == feat.dtype == torch.bfloat16
        assert feat.shape == (16, 16 + 6)

    @pytest.mark.parametrize("plain", [False, True])
    @pytest.mark.parametrize("remap", [False, True])
    def test_loss_and_gradients_match_reference(self, remap, plain):
        jcfg, cfg = jdlrm.DLRMConfig(**TINY), configs.DLRMConfig(**TINY)
        jp, tp = _models(remap, seed=5)
        jb, tb = _batch("bfloat16", seed=6)
        extra = {"rank_of": jp["rank_of"]} if remap else {}
        jloss, jgrads = jax.value_and_grad(
            lambda p: jdlrm.loss({**p, **extra}, jb, jcfg))(_leaves(jp))
        leaves = [x.detach().requires_grad_()
                  for x in tree.leaves(_leaves(tp))]
        p = tree.unflatten(_leaves(tp), leaves)
        if remap:
            p = dlrm.add_remap(p, tp["rank_of"], tp["hot_sizes"])
        loss = dlrm.loss(p, tb, cfg, plain=plain)
        grads = torch.autograd.grad(loss, leaves)
        assert loss.dtype == torch.float32 == DTYPES[str(jloss.dtype)][1]
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   **BF16_TOL)
        want = jax.tree.leaves(jgrads)
        assert len(grads) == len(want) == 4 + 3 + 4
        for g, w in zip(grads, want, strict=True):
            assert g.dtype == torch.bfloat16 == DTYPES[str(w.dtype)][1]
            assert g.shape == w.shape
            np.testing.assert_allclose(g.float().numpy(), _f32(w),
                                       **BF16_TOL)
            # the table gradients are far below atol, so each tensor is
            # also held as a whole, relative to its norm
            err = np.linalg.norm(g.float().numpy() - _f32(w))
            assert err <= BF16_TOL["rtol"] * np.linalg.norm(_f32(w))

    @pytest.mark.parametrize("plain", [False, True])
    @pytest.mark.parametrize("remap", [False, True])
    def test_retrieval_matches_reference(self, remap, plain):
        jcfg, cfg = jdlrm.DLRMConfig(**TINY), configs.DLRMConfig(**TINY)
        jp, tp = _models(remap, seed=7)
        rng = np.random.default_rng(8)
        dense = rng.standard_normal((1, 13)).astype(np.float32)
        idx = rng.integers(0, V, (1, 3, 4)).astype(np.int32)
        cand = rng.integers(0, V, 40).astype(np.int32)
        want = jdlrm.retrieval_score(
            jp, {"dense": jnp.asarray(dense, jnp.bfloat16),
                 "indices": jnp.asarray(idx),
                 "candidates": jnp.asarray(cand)}, jcfg)
        got = dlrm.retrieval_score(
            tp, {"dense": torch.from_numpy(dense).to(torch.bfloat16),
                 "indices": torch.from_numpy(idx),
                 "candidates": torch.from_numpy(cand)}, cfg, plain=plain)
        assert got.dtype == torch.bfloat16 == DTYPES[str(want.dtype)][1]
        np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                   **BF16_TOL)


OPTIMIZERS = {
    "adagrad-rowwise": lambda m: m.adagrad(0.05, rowwise=True),
    "adagrad": lambda m: m.adagrad(0.05),
    "adamw": lambda m: m.adamw(0.01),
    "partitioned": lambda m: m.partitioned(
        lambda ks: "table" if "tables" in ks else "dense",
        {"table": m.adagrad(0.05, rowwise=True), "dense": m.adamw(0.01)}),
}


class TestBF16Optimizers:
    @pytest.mark.parametrize("name", list(OPTIMIZERS))
    def test_float32_state_and_bf16_params(self, name):
        """Accumulators and moments stay float32 for bf16 params, and the
        params bf16, over 3 steps; the values are the reference's at bf16
        tolerance. (The reference's adamw keeps bf16 moments and returns a
        float32 param: see repro_torch.optim.)"""
        rng = np.random.default_rng(0)
        shapes = {"tables": [(20, 8), (30, 8)],
                  "bot": [{"w": (5, 8), "b": (8,)}]}
        params = jax.tree.map(lambda s: rng.standard_normal(s).astype(
            np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
        tp = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                          params)
        jopt, topt = OPTIMIZERS[name](jax_optim), OPTIMIZERS[name](optim)
        js, ts = jopt.init(jp), topt.init(tp)
        for _ in range(3):
            g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
                np.float32), params)
            jp, js = jopt.update(jax.tree.map(
                lambda a: jnp.asarray(a, jnp.bfloat16), g), js, jp)
            tp, ts = topt.update(jax.tree.map(
                lambda a: torch.from_numpy(a).to(torch.bfloat16), g), ts, tp)
        assert all(x.dtype == torch.bfloat16 for x in tree.leaves(tp))
        floats = [x for x in tree.leaves(ts) if x.is_floating_point()]
        assert floats and all(x.dtype == torch.float32 for x in floats)
        for got, want in zip(tree.leaves(tp), jax.tree.leaves(jp),
                             strict=True):
            np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                       **BF16_TOL)
        for got, want in zip(tree.leaves(ts), jax.tree.leaves(js),
                             strict=True):
            np.testing.assert_allclose(got.float().numpy(), _f32(want),
                                       **BF16_TOL)


BAD_IDS = [-1, V, V + 8]


class TestOutOfRangeIds:
    @pytest.mark.parametrize("bad", BAD_IDS)
    def test_lookup_clamps(self, bad):
        table = torch.arange(V * 2, dtype=torch.float32).reshape(V, 2)
        want = table[min(max(bad, 0), V - 1)]
        for dt in (torch.int32, torch.int64):
            got = layout.lookup(table, torch.tensor([[bad, 3]], dtype=dt))
            assert torch.equal(got[0, 0], want)
            assert torch.equal(got[0, 1], table[3])

    @pytest.mark.parametrize("plain", [False, True])
    @pytest.mark.parametrize("remap", [False, True])
    @pytest.mark.parametrize("bad", BAD_IDS)
    def test_forward_equals_hand_clamped_ids(self, bad, remap, plain):
        """-1, V and V+8 give the logits of the same batch with its ids
        clamped by hand into [0, V), on both routes."""
        cfg = configs.DLRMConfig(**TINY)
        _, tp = _models(remap, seed=2)
        _, tb = _batch("bfloat16", seed=4)
        idx = tb["indices"].clone()
        idx[3, 1, 2] = idx[0, 0, 0] = bad
        clamped = idx.clamp(0, V - 1)
        got = dlrm.forward(tp, {**tb, "indices": idx}, cfg, plain=plain)
        want = dlrm.forward(tp, {**tb, "indices": clamped}, cfg, plain=plain)
        assert torch.isfinite(got.float()).all()
        assert torch.equal(got, want)
        cand = torch.tensor([bad, 7, V - 1], dtype=torch.int32)
        user = {"dense": tb["dense"][:1], "indices": idx[:1]}
        got = dlrm.retrieval_score(tp, {**user, "candidates": cand}, cfg,
                                   plain=plain)
        want = dlrm.retrieval_score(
            tp, {"dense": user["dense"], "indices": clamped[:1],
                 "candidates": cand.clamp(0, V - 1)}, cfg, plain=plain)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("remap", [False, True])
    def test_gradients_equal_hand_clamped_ids(self, remap):
        """The Functions' backward adds each bad id's gradient where the
        forward read it."""
        cfg = configs.DLRMConfig(**TINY)
        _, tp = _models(remap, seed=2)
        _, tb = _batch("bfloat16", seed=4)
        idx = tb["indices"].clone()
        idx[:, 0, 0] = torch.tensor(BAD_IDS * 5 + [2], dtype=torch.int32)

        def grads(ids):
            leaves = [x.detach().requires_grad_() for x in tp["tables"]]
            p = {**tp, "tables": leaves}
            if remap:
                p = dlrm.add_remap(p, tp["rank_of"], tp["hot_sizes"])
            return torch.autograd.grad(
                dlrm.loss(p, {**tb, "indices": ids}, cfg), leaves)

        for g, w in zip(grads(idx), grads(idx.clamp(0, V - 1)), strict=True):
            assert torch.equal(g, w)

    @pytest.mark.parametrize("bad", BAD_IDS)
    def test_kernel_entries_and_bags_clamp(self, bad):
        rng = np.random.default_rng(9)
        table = torch.from_numpy(rng.standard_normal((V, 8)).astype(
            np.float32))
        idx = torch.from_numpy(rng.integers(0, V, (4, 5)).astype(np.int32))
        idx[1, 2] = bad
        clamped = idx.clamp(0, V - 1)
        assert torch.equal(ops.recflash_sls(table[:10], table[10:], idx,
                                            block_b=4),
                           ops.recflash_sls(table[:10], table[10:], clamped,
                                            block_b=4))
        rank_of = [torch.from_numpy(rng.permutation(V).astype(np.int32))]
        assert torch.equal(
            ops.recflash_sls_grouped([table], [10], idx[:, None], rank_of),
            ops.recflash_sls_grouped([table], [10], clamped[:, None],
                                     rank_of))
        for mode in ("sum", "mean", "max"):
            assert torch.equal(bag.embedding_bag_dense(table, idx, mode),
                               bag.embedding_bag_dense(table, clamped, mode))
        seg = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32)
        assert torch.equal(
            bag.embedding_bag_ragged(table, idx[1], seg, 2),
            bag.embedding_bag_ragged(table, clamped[1], seg, 2))

    def test_reference_fills_where_the_port_clamps(self):
        """The difference the docstrings state: the reference forward reads
        row V-1 for -1 and gives NaN for V and past it."""
        jcfg = jdlrm.DLRMConfig(**TINY)
        jp, _ = _models(remap=False)
        jb, _ = _batch("float32")
        idx = np.asarray(jb["indices"]).copy()

        def fwd(bad):
            i = idx.copy()
            i[0, 0, 0] = bad
            return np.asarray(jdlrm.forward(jp, {**jb,
                                                 "indices": jnp.asarray(i)},
                                            jcfg))

        np.testing.assert_array_equal(fwd(-1), fwd(V - 1))
        for bad in (V, V + 8):
            out = fwd(bad)
            assert np.isnan(out[0]) and np.isfinite(out[1:]).all()


def test_plain_grouped_sls_gradient_adds_up_in_float32():
    """The plain grouped SLS's table gradient under autograd adds in
    float32 and rounds once, as the kernel's Function's does: 4096 bags
    of one repeated id give that row a gradient of 4096 in bf16, where
    adding in bf16 would stall at 256. Without a gradient the rows are
    gathered before they are widened, with the same values."""
    table = torch.randn(10, 8).to(torch.bfloat16).requires_grad_()
    idx = torch.zeros(4096, 1, 1, dtype=torch.int32)
    out = ops.sls_grouped_ref([table], [1], idx)
    (g,) = torch.autograd.grad(out.float().sum(), table)
    assert g.dtype == torch.bfloat16
    assert torch.equal(g[0], torch.full((8,), 4096.0, dtype=torch.bfloat16))
    assert not g[1:].any()
    with torch.no_grad():
        torch.testing.assert_close(ops.sls_grouped_ref([table], [1], idx),
                                   out.detach(), rtol=0, atol=0)
