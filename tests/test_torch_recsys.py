"""The port's other recsys models (DIN, BERT4Rec, GraphSAGE) against the
JAX reference, on the CPU.

At the sizes of the reference's own tests (``tests/test_models.py``), the
reference's init is transplanted (``weights.from_jax_tree``) and the same
seeded numpy inputs go through both packages: forwards, losses and every
gradient leaf are held at float32 ``rtol=1e-5, atol=1e-5`` (the two
frameworks sum and multiply in other orders, each O(1e-7) relative), and
the properties the reference's tests pin (masked history, bidirectional
attention, sampled equals full) are held on the port.
"""

import ast
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from repro.configs import bert4rec_arch as jax_bert4rec_arch
from repro.configs import din_arch as jax_din_arch
from repro.configs import graphsage_reddit as jax_sage_arch
from repro.configs import recsys_common as jax_recsys_common
from repro.data import sampler as jax_sampler
from repro.models import bert4rec as jbert
from repro.models import common as jcommon
from repro.models import din as jdin
from repro.models import graphsage as jsage
from repro_torch import configs, tree, weights
from repro_torch.data import sampler
from repro_torch.models import bert4rec, common, din, graphsage

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(params):
    return weights.from_jax_tree(jax.tree.map(np.asarray, params), "cpu")


def _torch(batch):
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, list)
                else [torch.from_numpy(np.asarray(x)) for x in v])
            for k, v in batch.items()}


def _jax(batch):
    return jax.tree.map(jnp.asarray, batch)


def _value_and_grads(fn, params):
    """Port: the loss and {keystr path: gradient} of ``fn(params)``."""
    flat = tree.flatten_with_path(params)
    leaves = [x.detach().requires_grad_() for _, x in flat]
    loss = fn(tree.unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {p: g for (p, _), g in zip(flat, grads,
                                                     strict=True)}


def _jgrad(fn, params):
    """Reference: the loss and gradients of ``fn(params)``, jitted (the
    eager op-by-op gradient takes seconds at these sizes)."""
    return jax.jit(jax.value_and_grad(fn))(params)


def _check_grads(got: dict, want_tree, tol=TOL):
    want = {keystr(p): np.asarray(g)
            for p, g in tree_flatten_with_path(want_tree)[0]}
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert g.shape == want[path].shape, path
        np.testing.assert_allclose(g.numpy(), want[path], err_msg=path,
                                   **tol)


class TestDIN:
    cfg_kw = dict(n_items=1000, seq_len=20)

    def setup_method(self):
        self.jcfg = jdin.DINConfig(**self.cfg_kw)
        self.cfg = din.DINConfig(**self.cfg_kw)
        self.jparams = jdin.init(jax.random.PRNGKey(0), self.jcfg)
        self.params = _port(self.jparams)

    def _batch(self, b=8, seed=1):
        rng = np.random.default_rng(seed)
        mask = np.ones((b, 20), bool)
        mask[:, 15:] = False
        return {"hist": rng.integers(0, 1000, (b, 20)).astype(np.int32),
                "hist_mask": mask,
                "target": rng.integers(0, 1000, b).astype(np.int32),
                "profile": rng.standard_normal((b, 8)).astype(np.float32),
                "labels": (rng.random(b) > 0.5).astype(np.float32)}

    def test_config_equals_reference(self):
        assert dataclasses.asdict(configs.DIN) == \
            dataclasses.asdict(jax_din_arch.CONFIG)
        assert self.cfg.mlp_in == self.jcfg.mlp_in
        assert self.cfg.flops_per_sample() == self.jcfg.flops_per_sample()

    def test_forward_loss_and_grads_match_reference(self):
        batch = self._batch()
        want = jdin.forward(self.jparams, _jax(batch), self.jcfg)
        got = din.forward(self.params, _torch(batch), self.cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        jloss, jgrads = _jgrad(
            lambda p: jdin.loss(p, _jax(batch), self.jcfg), self.jparams)
        loss, grads = _value_and_grads(
            lambda p: din.loss(p, _torch(batch), self.cfg), self.params)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        _check_grads(grads, jgrads)

    def test_masked_history_ignored(self):
        batch = _torch(self._batch())
        out1 = din.forward(self.params, batch, self.cfg)
        hist2 = batch["hist"].clone()
        hist2[:, 15:] = 7
        out2 = din.forward(self.params, {**batch, "hist": hist2}, self.cfg)
        torch.testing.assert_close(out1, out2, rtol=1e-5, atol=0)

    @pytest.mark.parametrize("chunk", [din.RETRIEVAL_CHUNK, 7])
    def test_retrieval_matches_reference(self, chunk, monkeypatch):
        rng = np.random.default_rng(2)
        b = {"hist": rng.integers(0, 1000, (1, 20)).astype(np.int32),
             "hist_mask": np.ones((1, 20), bool),
             "profile": rng.standard_normal((1, 8)).astype(np.float32),
             "candidates": np.arange(50, dtype=np.int32)}
        want = jdin.retrieval_score(self.jparams, _jax(b), self.jcfg)
        monkeypatch.setattr(din, "RETRIEVAL_CHUNK", chunk)
        got = din.retrieval_score(self.params, _torch(b), self.cfg)
        assert got.shape == (50,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_retrieval_equals_the_forward_per_candidate(self, monkeypatch):
        """Scoring N candidates for one user is the forward of N rows with
        that user's history."""
        rng = np.random.default_rng(3)
        b = {"hist": rng.integers(0, 1000, (1, 20)).astype(np.int32),
             "hist_mask": rng.random((1, 20)) > 0.3,
             "profile": rng.standard_normal((1, 8)).astype(np.float32),
             "candidates": rng.integers(0, 1000, 9).astype(np.int32)}
        tb = _torch(b)
        monkeypatch.setattr(din, "RETRIEVAL_CHUNK", 4)
        got = din.retrieval_score(self.params, tb, self.cfg)
        rows = {"hist": tb["hist"].expand(9, -1),
                "hist_mask": tb["hist_mask"].expand(9, -1),
                "target": tb["candidates"],
                "profile": tb["profile"].expand(9, -1)}
        torch.testing.assert_close(got, din.forward(self.params, rows,
                                                    self.cfg),
                                   rtol=1e-6, atol=1e-6)


class TestBert4Rec:
    cfg_kw = dict(n_items=500, seq_len=24)

    def setup_method(self):
        self.jcfg = jbert.Bert4RecConfig(**self.cfg_kw)
        self.cfg = bert4rec.Bert4RecConfig(**self.cfg_kw)
        self.jparams = jbert.init(jax.random.PRNGKey(0), self.jcfg)
        self.params = _port(self.jparams)

    def _items(self, b, seed, pad=False):
        rng = np.random.default_rng(seed)
        pad_mask = np.ones((b, 24), bool)
        if pad:
            pad_mask[:, :5] = False
        return {"items": rng.integers(1, 500, (b, 24)).astype(np.int32),
                "pad_mask": pad_mask}

    def test_configs_equal_reference(self):
        """The model's default config (ML-20m's 26,744 items) and the
        registry's (``bert4rec_arch.CONFIG``: padded to /16, 26,752)."""
        assert dataclasses.asdict(bert4rec.Bert4RecConfig()) == \
            dataclasses.asdict(jbert.Bert4RecConfig())
        assert dataclasses.asdict(configs.BERT4REC) == \
            dataclasses.asdict(jax_bert4rec_arch.CONFIG)
        assert configs.BERT4REC.n_items == 26_752
        assert configs.BERT4REC_N_MASK == jax_bert4rec_arch.N_MASK
        assert self.cfg.flops_per_sample() == self.jcfg.flops_per_sample()

    @pytest.mark.parametrize("pad", [False, True])
    def test_encode_and_score_match_reference(self, pad):
        batch = self._items(4, 3, pad)
        want = jbert.encode(self.jparams, jnp.asarray(batch["items"]),
                            jnp.asarray(batch["pad_mask"]), self.jcfg)
        got = bert4rec.encode(self.params, torch.from_numpy(batch["items"]),
                              torch.from_numpy(batch["pad_mask"]), self.cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        want = jbert.score(self.jparams, _jax(batch), self.jcfg)
        got = bert4rec.score(self.params, _torch(batch), self.cfg)
        assert got.shape == (4, 500)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_cloze_loss_and_grads_match_reference(self):
        b, m = 4, 4
        rng = np.random.default_rng(2)
        tmask = np.ones((b, m), bool)
        tmask[0, 3] = False
        batch = {**self._items(b, 1, pad=True),
                 "mask_pos": np.tile(np.array([7, 11, 19, 23], np.int32),
                                     (b, 1)),
                 "targets": rng.integers(1, 500, (b, m)).astype(np.int32),
                 "target_mask": tmask}
        jloss, jgrads = _jgrad(
            lambda p: jbert.loss(p, _jax(batch), self.jcfg), self.jparams)
        loss, grads = _value_and_grads(
            lambda p: bert4rec.loss(p, _torch(batch), self.cfg), self.params)
        assert float(loss) > 0
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        _check_grads(grads, jgrads)

    def test_retrieval_matches_reference(self):
        batch = {**self._items(1, 4),
                 "candidates": np.random.default_rng(5).integers(
                     0, 500, 60).astype(np.int32)}
        want = jbert.retrieval_score(self.jparams, _jax(batch), self.jcfg)
        got = bert4rec.retrieval_score(self.params, _torch(batch), self.cfg)
        assert got.shape == (60,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_bidirectional_attention(self):
        """Future positions influence earlier scores (encoder, not
        causal)."""
        items = torch.ones((1, 24), dtype=torch.int32)
        pad = torch.ones((1, 24), dtype=torch.bool)
        h1 = bert4rec.encode(self.params, items, pad, self.cfg)
        items2 = items.clone()
        items2[0, -1] = 42
        h2 = bert4rec.encode(self.params, items2, pad, self.cfg)
        assert float((h1[0, 0] - h2[0, 0]).abs().max()) > 0

    def test_layer_norm_matches_reference(self):
        rng = np.random.default_rng(6)
        x = rng.standard_normal((5, 7)).astype(np.float32) * 3 + 1
        g = rng.standard_normal(7).astype(np.float32)
        b = rng.standard_normal(7).astype(np.float32)
        want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                  jnp.asarray(b))
        got = common.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                                torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        ln = common.ln_init(7)
        assert torch.equal(ln["gamma"], torch.ones(7))
        assert torch.equal(ln["beta"], torch.zeros(7))


class TestGraphSAGE:
    def test_configs_equal_reference(self):
        for name in ("CFG_REDDIT", "CFG_CORA", "CFG_PRODUCTS",
                     "CFG_MOLECULE"):
            assert dataclasses.asdict(getattr(configs, name)) == \
                dataclasses.asdict(getattr(jax_sage_arch, name))
        assert configs.SAGE_SHAPES == jax_sage_arch.SHAPES
        assert configs.RECSYS_SHAPES == jax_recsys_common.RECSYS_SHAPES

    def test_full_graph_matches_reference(self):
        jcfg = jsage.SAGEConfig(d_in=16, n_classes=4)
        cfg = graphsage.SAGEConfig(d_in=16, n_classes=4)
        jparams = jsage.init(jax.random.PRNGKey(0), jcfg)
        params = _port(jparams)
        n, e = 50, 200
        rng = np.random.default_rng(0)
        mask = np.ones(n, np.float32)
        mask[::3] = 0
        batch = {"feats": rng.normal(size=(n, 16)).astype(np.float32),
                 "edge_src": rng.integers(0, n, e).astype(np.int32),
                 "edge_dst": rng.integers(0, n, e).astype(np.int32),
                 "labels": rng.integers(0, 4, n).astype(np.int32),
                 "train_mask": mask}
        jb, tb = _jax(batch), _torch(batch)
        np.testing.assert_allclose(
            graphsage.forward_full(params, tb["feats"], tb["edge_src"],
                                   tb["edge_dst"], cfg).numpy(),
            np.asarray(jsage.forward_full(jparams, jb["feats"],
                                          jb["edge_src"], jb["edge_dst"],
                                          jcfg)), **TOL)
        jloss, jgrads = _jgrad(
            lambda p: jsage.loss_node(p, jb, jcfg, "full"), jparams)
        loss, grads = _value_and_grads(
            lambda p: graphsage.loss_node(p, tb, cfg, "full"), params)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        _check_grads(grads, jgrads)

    def test_sampled_blocks_match_reference(self):
        jcfg = jsage.SAGEConfig(d_in=8, n_classes=3, fanouts=(4, 3))
        cfg = graphsage.SAGEConfig(d_in=8, n_classes=3, fanouts=(4, 3))
        jparams = jsage.init(jax.random.PRNGKey(0), jcfg)
        params = _port(jparams)
        g = sampler.CSRGraph.random(100, avg_degree=5, d_feat=8, n_classes=3)
        blocks = sampler.sample_blocks(g, np.arange(16), (4, 3),
                                       np.random.default_rng(1))
        jg = jax_sampler.CSRGraph.random(100, avg_degree=5, d_feat=8,
                                         n_classes=3)
        jblocks = jax_sampler.sample_blocks(jg, np.arange(16), (4, 3),
                                            np.random.default_rng(1))
        jb, tb = _jax(jblocks), _torch(blocks)
        want = jsage.forward_sampled(jparams, jb, jcfg)
        got = graphsage.forward_sampled(params, tb, cfg)
        assert got.shape == (16, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        jloss, jgrads = _jgrad(
            lambda p: jsage.loss_node(p, jb, jcfg, "sampled"), jparams)
        loss, grads = _value_and_grads(
            lambda p: graphsage.loss_node(p, tb, cfg, "sampled"), params)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        _check_grads(grads, jgrads)

    def test_sampled_matches_full_when_fanout_covers(self):
        """On a ring (each node one in-neighbour) a fanout of 1 samples the
        whole neighbourhood, so the sampled forward is the full one."""
        cfg = graphsage.SAGEConfig(d_in=4, n_classes=2, fanouts=(50, 50))
        params = graphsage.init(0, cfg, device="cpu")
        n = 10
        src, dst = np.arange(n), (np.arange(n) + 1) % n
        feats = np.random.default_rng(2).normal(size=(n, 4)).astype(
            np.float32)
        full = graphsage.forward_full(params, torch.from_numpy(feats),
                                      torch.from_numpy(src),
                                      torch.from_numpy(dst), cfg)
        g = sampler.CSRGraph.from_edges(n, src, dst, feats,
                                        np.zeros(n, np.int64))
        blocks = sampler.sample_blocks(g, np.arange(n), (1, 1),
                                       np.random.default_rng(0))
        sampled = graphsage.forward_sampled(params, _torch(blocks), cfg)
        torch.testing.assert_close(sampled, full, rtol=0, atol=1e-5)

    def test_batched_molecule_graphs_match_reference(self):
        jcfg = jsage.SAGEConfig(d_in=6, n_classes=2)
        cfg = graphsage.SAGEConfig(d_in=6, n_classes=2)
        jparams = jsage.init(jax.random.PRNGKey(0), jcfg)
        params = _port(jparams)
        b, n, e = 8, 10, 16
        rng = np.random.default_rng(3)
        emask = rng.random((b, e)) > 0.2
        nmask = np.ones((b, n), bool)
        nmask[:, 8:] = False
        args = {"x": rng.normal(size=(b, n, 6)).astype(np.float32),
                "edges": rng.integers(0, n, (b, e, 2)).astype(np.int32),
                "emask": emask, "nmask": nmask}
        ja, ta = _jax(args), _torch(args)
        want = jsage.forward_batched_graphs(jparams, ja["x"], ja["edges"],
                                            ja["emask"], ja["nmask"], jcfg)
        got = graphsage.forward_batched_graphs(params, ta["x"], ta["edges"],
                                               ta["emask"], ta["nmask"], cfg)
        assert got.shape == (8, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _, jgrads = _jgrad(
            lambda p: jsage.forward_batched_graphs(
                p, ja["x"], ja["edges"], ja["emask"], ja["nmask"],
                jcfg).sum(), jparams)
        _, grads = _value_and_grads(
            lambda p: graphsage.forward_batched_graphs(
                p, ta["x"], ta["edges"], ta["emask"], ta["nmask"],
                cfg).sum(), params)
        _check_grads(grads, jgrads)

    def test_batched_graphs_equal_one_graph_at_a_time(self):
        """Laying the graphs end to end changes nothing: each graph's
        logits are those of the same graph alone."""
        cfg = graphsage.SAGEConfig(d_in=6, n_classes=2)
        params = graphsage.init(1, cfg, device="cpu")
        rng = np.random.default_rng(4)
        x = torch.from_numpy(rng.normal(size=(3, 7, 6)).astype(np.float32))
        edges = torch.from_numpy(rng.integers(0, 7, (3, 9, 2)))
        emask = torch.ones((3, 9), dtype=torch.bool)
        nmask = torch.ones((3, 7), dtype=torch.bool)
        all_at_once = graphsage.forward_batched_graphs(params, x, edges,
                                                       emask, nmask, cfg)
        for i in range(3):
            one = graphsage.forward_batched_graphs(
                params, x[i:i + 1], edges[i:i + 1], emask[i:i + 1],
                nmask[i:i + 1], cfg)
            torch.testing.assert_close(all_at_once[i:i + 1], one,
                                       rtol=1e-6, atol=1e-6)


def test_weights_from_jax_tree_copies_every_leaf():
    jparams = jbert.init(jax.random.PRNGKey(1),
                         jbert.Bert4RecConfig(n_items=50, seq_len=8,
                                              n_blocks=1))
    np_tree = jax.tree.map(np.asarray, jparams)
    got = weights.from_jax_tree(np_tree, "cpu")
    want = {keystr(p): x for p, x in tree_flatten_with_path(np_tree)[0]}
    flat = dict(tree.flatten_with_path(got))
    assert sorted(flat) == sorted(want)
    for path, x in flat.items():
        np.testing.assert_array_equal(x.numpy(), want[path])
    bf = weights.from_jax_tree({"w": [np.asarray(jnp.ones(3, jnp.bfloat16))]},
                               "cpu")
    assert bf["w"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("mod", [din, bert4rec, graphsage, sampler, configs,
                                 weights])
def test_modules_import_no_jax(mod):
    names = []
    for node in ast.walk(ast.parse(inspect.getsource(mod))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [m for m in names if m.split(".")[0] in ("jax", "repro")]


def test_init_shapes_match_reference():
    for jmod, mod, kw in ((jdin, din, dict(n_items=300, seq_len=10)),
                          (jbert, bert4rec, dict(n_items=300, seq_len=10)),
                          (jsage, graphsage, dict(d_in=12, n_classes=3))):
        cfg_name = {jdin: "DINConfig", jbert: "Bert4RecConfig",
                    jsage: "SAGEConfig"}[jmod]
        jp = jmod.init(jax.random.PRNGKey(0), getattr(jmod, cfg_name)(**kw))
        tp = mod.init(0, getattr(mod, cfg_name)(**kw), device="cpu")
        want = {keystr(p): x.shape for p, x in tree_flatten_with_path(jp)[0]}
        assert {p: tuple(x.shape) for p, x in tree.flatten_with_path(tp)} \
            == want
