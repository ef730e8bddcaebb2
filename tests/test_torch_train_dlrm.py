"""The port's DLRM training against the JAX reference, on the CPU: the loss
and its gradients through the kernels' ``autograd.Function``s, the training
pipeline of ``launch/train.py`` from a transplanted init. Its CLI is driven
in ``test_torch_train_cli.py``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.tree_util import keystr, tree_flatten_with_path

import repro.launch.train as jax_train
import repro.models.dlrm as jdlrm
from repro.embedding.layout import RemapSpec as JaxRemapSpec
from repro.embedding.layout import remap_table as jax_remap_table
from repro_torch import configs, tree
from repro_torch.kernels import ref
from repro_torch.kernels.dot_interaction import DotInteractionFused
from repro_torch.kernels.recflash_sls import RecFlashSLSGrouped
from repro_torch.launch import train
from repro_torch.models import dlrm
from repro_torch.weights import from_jax_params

def _to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def _pairs(jax_tree, torch_tree):
    """{keystr: (jax leaf, torch leaf)}; asserts the same paths."""
    want = {keystr(p): np.asarray(x)
            for p, x in tree_flatten_with_path(jax_tree)[0]}
    got = {p: x for p, x in tree.flatten_with_path(torch_tree)}
    assert list(got) == list(want)
    return {k: (want[k], got[k]) for k in want}


TINY = dict(name="tiny", n_tables=3, n_dense=13, embed_dim=16,
            n_rows=(300,) * 3, lookups=4, bot_mlp=(32, 16), top_mlp=(32,))


class TestLossAndGradients:
    # value and gradients of one f32 loss in two orders of summation (the
    # bags, the Gram dots, and the scatter of the table gradients)
    TOL = dict(rtol=1e-5, atol=1e-7)

    def test_value_and_grad_match_reference(self):
        jcfg, tcfg = jdlrm.DLRMConfig(**TINY), configs.DLRMConfig(**TINY)
        params = jdlrm.init(jax.random.PRNGKey(1), jcfg)
        counts = np.random.default_rng(2).integers(0, 30, (3, 300))
        specs = [JaxRemapSpec.from_counts(c, hot_size=h)
                 for c, h in zip(counts, (1, 30, 299), strict=True)]
        params["tables"] = [jax_remap_table(t, s) for t, s in
                            zip(params["tables"], specs, strict=True)]
        rank_ofs = [s.rank_of for s in specs]
        rng = np.random.default_rng(3)
        batch = {"dense": rng.standard_normal((16, 13)).astype(np.float32),
                 "indices": rng.integers(0, 300, (16, 3, 4)).astype(np.int32),
                 "labels": (rng.random(16) > 0.5).astype(np.float32)}
        want_loss, want_g = jax.jit(jax.value_and_grad(
            lambda p: jdlrm.loss(jdlrm.add_remap(p, rank_ofs),
                                 _to_jax(batch), jcfg)))(params)

        tp = from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
        leaves = [x.requires_grad_() for x in tree.leaves(tp)]
        p = tree.unflatten(tp, leaves)
        pp = dlrm.add_remap(p, rank_ofs, [s.hot_size for s in specs])
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        logits = dlrm.forward(pp, tbatch, tcfg)
        # the graph goes through both Functions, not autograd of the plain
        # versions
        names, seen, stack = set(), set(), [logits.grad_fn]
        while stack:
            fn = stack.pop()
            if fn is not None and id(fn) not in seen:
                seen.add(id(fn))
                names.add(type(fn).__name__)
                stack.extend(f for f, _ in fn.next_functions)
        assert {"RecFlashSLSGroupedBackward",
                "DotInteractionFusedBackward"} <= names
        loss = dlrm.loss(pp, tbatch, tcfg)
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(loss.item(), float(want_loss), **self.TOL)
        tgrads = tree.unflatten(tp, list(grads))
        pairs = _pairs(want_g, tgrads)
        assert len(pairs) == 3 + 4 + 4          # tables, bot and top w, b
        for want, got in pairs.values():
            np.testing.assert_allclose(got.numpy(), want, **self.TOL)
        # a bag no lookup touched gets a zero row, as jax.grad gives
        assert (tgrads["tables"][0].abs().sum(1) == 0).any()

    def test_function_backwards_equal_autograd_of_the_plain_versions(self):
        rng = np.random.default_rng(4)
        tables = [torch.from_numpy(rng.standard_normal((v, 8)).astype(
            np.float32)).requires_grad_() for v in (20, 30)]
        rank_of = [torch.from_numpy(rng.permutation(v).astype(np.int32))
                   for v in (20, 30)]
        idx = torch.from_numpy(rng.integers(0, 20, (6, 2, 5)).astype(
            np.int32))
        g = torch.from_numpy(rng.standard_normal((6, 2, 8)).astype(
            np.float32))
        hot = [3, 29]
        got = torch.autograd.grad(RecFlashSLSGrouped.apply(
            hot, idx, rank_of, None, None, *tables), tables, g)
        want = torch.autograd.grad(ref.recflash_sls_grouped_ref(
            tables, hot, idx, rank_of), tables, g)
        for a, b in zip(got, want, strict=True):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        x = torch.from_numpy(rng.standard_normal((6, 8)).astype(
            np.float32)).requires_grad_()
        bags = torch.from_numpy(rng.standard_normal((6, 4, 8)).astype(
            np.float32)).requires_grad_()
        gf = torch.from_numpy(rng.standard_normal((6, 8 + 10)).astype(
            np.float32))
        got = torch.autograd.grad(DotInteractionFused.apply(x, bags),
                                  (x, bags), gf)
        want = torch.autograd.grad(ref.dot_interaction_fused_ref(x, bags),
                                   (x, bags), gf)
        for a, b in zip(got, want, strict=True):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    def test_no_grad_calls_the_entries_directly(self):
        cfg = configs.DLRMConfig(**TINY)
        p = dlrm.init(0, cfg, device="cpu")
        for x in tree.leaves(p):
            x.requires_grad_()
        batch = {"dense": torch.zeros(4, 13),
                 "indices": torch.zeros(4, 3, 4, dtype=torch.int32)}
        with torch.no_grad():
            assert dlrm.forward(p, batch, cfg).grad_fn is None


def _args(**kw):
    base = dict(seed=0, batch=64, lr=1e-3, lr_table=0.02, device="cpu")
    return argparse.Namespace(**{**base, **kw})


class TestDLRMPipeline:
    # 20 steps of f32 training in two frameworks: per step the sums of the
    # forward and the scatters of the backward run in other orders, and
    # adamw and adagrad carry those differences on
    TOL = dict(rtol=2e-4, atol=2e-6)
    ROWS = 2000

    def test_loss_curve_and_params_match_reference(self, monkeypatch):
        small = jax_train.small_dlrm
        monkeypatch.setattr(jax_train, "small_dlrm",
                            lambda: small(n_rows=self.ROWS))
        args = _args()
        jparams, jopt, jloss, jbatch = jax_train._dlrm_pipeline(args, True)
        params, opt, loss_fn, batch_fn = train._dlrm_pipeline(
            args, True, cfg=configs.small_dlrm(n_rows=self.ROWS))
        # the port's own init differs from JAX's draws: transplant the
        # reference's (already remapped) tables and MLPs
        params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")

        @jax.jit
        def jstep(state, batch):
            p, s, _ = state
            loss, g = jax.value_and_grad(lambda q: jloss(q, batch))(p)
            p, s = jopt.update(g, s, p)
            return p, s, loss

        step = train.make_step(opt, loss_fn)
        js = (jparams, jopt.init(jparams), jnp.zeros(()))
        ts = (params, opt.init(params), torch.zeros(()))
        jl, tl = [], []
        for i in range(20):
            tb, jb = batch_fn(i), jbatch(i)
            for k in ("dense", "indices", "labels"):
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))
            js, ts = jstep(js, jb), step(ts, tb)
            jl.append(float(js[2]))
            tl.append(float(ts[2]))
        # the losses themselves agree to a few f32 ulps of their sums
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert np.mean(tl[-5:]) < np.mean(tl[:5])
        for want, got in _pairs((js[0], js[1]), (ts[0], ts[1])).values():
            np.testing.assert_allclose(got.numpy(), want, **self.TOL)
