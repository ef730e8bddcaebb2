"""The recsys and GNN half of the port's arch registry
(``repro_torch.configs``: ``recsys_common``, ``dlrm_mlperf``, ``dlrm_rm2``,
``rmc``, ``din_arch``, ``bert4rec_arch``, ``graphsage_reddit``,
``all_archs``) against the reference's, at full size, and its plan
functions on real tensors at narrow widths.

Full size: for every recsys and GNN arch the family, config, cells, kinds
and ``model_flops`` (rtol 1e-12); every param leaf's spec under
``param_rules``, the optimizer's rules and the serve cells'
``param_rules_override`` (the reference's trees through
``jax.eval_shape``, the port's on the ``meta`` device); every plan's
in/out specs, ``donate`` and argument shapes and dtypes on one pod and on
several. Building the 32 plans makes no real tensor.

Narrow: each cell's plan function (mesh None) against the reference's plan
function under ``jax.jit`` on one CPU device, on the same numpy inputs and
the reference's params (``weights.from_jax_tree``): DLRM serve and
retrieval f32 at ``rtol=1e-5, atol=1e-6`` and bf16 at 2e-2; the DLRM,
DIN, GraphSAGE and BERT4Rec (4 microbatches) train steps' loss and every
updated param at ``atol=1e-5``. The cells' batch sizes are cut
(``SMALL_SHAPES``), as the widths are.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from jax.tree_util import keystr, tree_flatten_with_path
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import base as jbase
from repro.configs import bert4rec_arch as jbert_arch
from repro.configs import din_arch as jdin_arch
from repro.configs import dlrm_mlperf as jmlperf
from repro.configs import graphsage_reddit as jsage_arch
from repro.configs import recsys_common as jrc
from repro.distributed.shardings import make_param_specs as jmake_specs
from repro_torch import configs, tree, weights
from repro_torch.configs import (bert4rec_arch, din_arch, dlrm_mlperf,
                                 graphsage_reddit, recsys_common)
from repro_torch.distributed.shardings import make_param_specs

RECSYS = ["dlrm-mlperf", "dlrm-rm2", "rmc1", "rmc2", "rmc3", "din",
          "bert4rec"]
GNN = ["graphsage-reddit"]
ARCHS = RECSYS + GNN
REC_CELLS = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]
GNN_CELLS = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
CELLS = [(a, c) for a in RECSYS for c in REC_CELLS] + \
    [(a, c) for a in GNN for c in GNN_CELLS]
SERVE_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
STEP_TOL = dict(rtol=0, atol=1e-5)
# the narrow runs' cells: the reference's batch sizes cut as the widths are
SMALL_SHAPES = {"train_batch": dict(batch=64), "serve_p99": dict(batch=32),
                "serve_bulk": dict(batch=48),
                "retrieval_cand": dict(batch=1, n_candidates=96)}


def _jax_specs(specs) -> dict:
    flat = tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))
    return {keystr(p): tuple(s) for p, s in flat[0]}


def _port_specs(specs) -> dict:
    return {p: tuple(s) for p, s in tree.flatten_with_path(specs)}


@pytest.fixture(scope="module")
def bundles():
    return {n: (jbase.get_arch(n), configs.get_arch(n)) for n in ARCHS}


@pytest.fixture(scope="module")
def plans(bundles):
    out = {}
    for name, cell in CELLS:
        jb, pb = bundles[name]
        for multi_pod in (False, True):
            out[name, cell, multi_pod] = (
                jb.steps[cell].make_fn(jb, None, multi_pod),
                pb.steps[cell].make_fn(pb, None, multi_pod))
    return out


def test_list_archs_equals_reference():
    assert configs.list_archs() == jbase.list_archs()
    assert len(configs.list_archs()) == 13


@pytest.mark.parametrize("name", ARCHS)
def test_bundle_matches_reference(bundles, name):
    jb, pb = bundles[name]
    assert (pb.name, pb.family, pb.notes) == (jb.name, jb.family, jb.notes)
    assert dataclasses.asdict(pb.cfg) == dataclasses.asdict(jb.cfg)
    assert list(pb.steps) == list(jb.steps)
    for shape, step in pb.steps.items():
        ref = jb.steps[shape]
        assert (step.kind, step.skip, step.donate, step.static,
                step.batch_arg_axes) == (ref.kind, ref.skip, ref.donate,
                                         ref.static, ref.batch_arg_axes)
        assert callable(step.make_fn)
    assert sorted(pb.model_flops) == sorted(jb.model_flops)
    for shape, flops in jb.model_flops.items():
        np.testing.assert_allclose(pb.model_flops[shape], flops, rtol=1e-12)
    assert recsys_common.RECSYS_SHAPES == jrc.RECSYS_SHAPES


def test_moved_constants_are_the_arch_modules():
    """``configs``' recsys names are the arch modules' objects, defined
    once."""
    assert configs.DLRM_MLPERF is dlrm_mlperf.CONFIG
    assert configs.DLRM_RM2 is configs.get_arch("dlrm-rm2").cfg
    assert configs.PARAM_RULES is dlrm_mlperf.PARAM_RULES
    assert configs.OPT_RULES_2D is dlrm_mlperf.OPT_RULES_2D
    assert configs.RECSYS_SHAPES is recsys_common.RECSYS_SHAPES
    assert configs.DIN is din_arch.CONFIG
    assert configs.BERT4REC is bert4rec_arch.CONFIG
    assert configs.BERT4REC_N_MASK == bert4rec_arch.N_MASK == \
        jbert_arch.N_MASK
    assert configs.SAGE_SHAPES is graphsage_reddit.SHAPES == \
        jsage_arch.SHAPES
    assert configs.MLPERF_VOCABS == jmlperf.MLPERF_VOCABS
    for name in ("CFG_REDDIT", "CFG_CORA", "CFG_PRODUCTS", "CFG_MOLECULE"):
        assert getattr(configs, name) is getattr(graphsage_reddit, name)
        assert dataclasses.asdict(getattr(configs, name)) == \
            dataclasses.asdict(getattr(jsage_arch, name))


@pytest.mark.parametrize("name", ARCHS)
def test_param_and_opt_rules_match_reference(bundles, plans, name):
    """Every param leaf's spec under the param rules and under the serve
    cells' override, and every optimizer-state leaf's."""
    jb, pb = bundles[name]
    jp = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0)))
    pp = pb.init(0, device="meta")
    assert _port_specs(make_param_specs(pp, pb.param_rules)) == \
        _jax_specs(jmake_specs(jp, jb.param_rules))
    if name == "graphsage-reddit":
        return
    for multi_pod in (False, True):
        jplan, pplan = plans[name, "train_batch", multi_pod]
        assert _port_specs(pplan.in_specs[1]) == \
            _jax_specs(jplan.in_specs[1])
        jplan, pplan = plans[name, "serve_p99", multi_pod]
        assert _port_specs(pplan.in_specs[0]) == \
            _jax_specs(jplan.in_specs[0])
    want = _jax_specs(jmake_specs(jax.eval_shape(jb.optimizer.init, jp),
                                  jb.rules_for_opt()))
    assert _port_specs(make_param_specs(pb.optimizer.init(pp),
                                        pb.rules_for_opt())) == want


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("name,cell", CELLS)
def test_plan_specs_match_reference(plans, name, cell, multi_pod):
    """Each plan's in/out specs and donate, and its args' shapes and dtypes
    (the microbatch leaves and the rank_of list included), on the meta
    device; the optimizer's AdamW moments are float32 in the port
    (``repro_torch.optim``), the params' dtype in the reference."""
    jplan, pplan = plans[name, cell, multi_pod]
    assert pplan.donate == jplan.donate
    assert _port_specs(pplan.in_specs) == _jax_specs(jplan.in_specs)
    assert _port_specs(pplan.out_specs) == _jax_specs(jplan.out_specs)

    def moment(path, dtype):
        return path.startswith("[1]") and "float" in dtype

    got = {p: (tuple(x.shape), str(x.dtype).split(".")[-1], x.device.type)
           for p, x in tree.flatten_with_path(pplan.args)}
    want = {keystr(p): (tuple(x.shape), str(x.dtype), "meta")
            for p, x in tree_flatten_with_path(jplan.args)[0]}
    want = {p: (s, "float32" if moment(p, dt) else dt, dev)
            for p, (s, dt, dev) in want.items()}
    assert got == want


def test_dlrm_dtype_rule():
    """bf16 tables and MLPs above 2M rows (dlrm-mlperf), f32 below."""
    for name, dtype in (("dlrm-mlperf", torch.bfloat16),
                        ("dlrm-rm2", torch.float32),
                        ("rmc2", torch.float32)):
        params = configs.get_arch(name).init(0, device="meta")
        assert {x.dtype for x in tree.leaves(params)} == {dtype}
    tables = configs.get_arch("dlrm-mlperf").init(0, device="meta")["tables"]
    assert sum(t.numel() * t.element_size() for t in tables) == \
        187_775_488 * 128 * 2


class _RealTensors(TorchDispatchMode):
    """Records every op whose output is a tensor off the meta device."""

    def __init__(self):
        super().__init__()
        self.real: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.device.type != "meta"
               for t in tree_leaves(out)):
            self.real.append(str(func))
        return out


def test_full_size_plans_allocate_nothing():
    """All 32 recsys and GNN plans at full size (dlrm-mlperf's 48 GB of
    tables, their optimizer state, the 1M-candidate batches) are built on
    the meta device: no op makes a real tensor."""
    with _RealTensors() as mode:
        built = [configs.get_arch(n).steps[c].make_fn(
            configs.get_arch(n), None, False) for n, c in CELLS]
    assert mode.real == []
    assert len(built) == 32
    for plan in built:
        leaves = tree.leaves(plan.args)
        assert leaves and all(x.device.type == "meta" for x in leaves)


# -- the plan functions on real tensors, narrow ------------------------------


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _to_torch(t):
    return weights.from_jax_tree(_np_tree(t), "cpu")


def _jax_args(args):
    return jax.tree.map(jnp.asarray, args)


@pytest.fixture
def small_shapes(monkeypatch):
    """Both registries' cells at SMALL_SHAPES' batch sizes (one dict shared
    by every arch module)."""
    for shapes in (jrc.RECSYS_SHAPES, recsys_common.RECSYS_SHAPES):
        for k, v in SMALL_SHAPES.items():
            monkeypatch.setitem(shapes, k, v)


NARROW_DLRM = dict(dim=8, bot=(5, 16, 8), top=(24, 16, 1),
                   vocabs=[40, 72, 3, 56], lookups=3)


def _dlrm_bundles(dtype=None, **kw):
    """A narrow dlrm-mlperf-shaped bundle from both registries (4 tables,
    D 8), in ``dtype`` if given."""
    jcfg = jmlperf.make_config(name="narrow", **NARROW_DLRM)
    pcfg = dlrm_mlperf.make_config(name="narrow", **NARROW_DLRM)
    jb = jmlperf.make_dlrm_bundle("narrow", jcfg, **kw)
    pb = dlrm_mlperf.make_dlrm_bundle("narrow", pcfg, **kw)
    if dtype is not None:
        from repro.models import dlrm as jdlrm
        from repro_torch.models import dlrm as pdlrm
        jb.init = functools.partial(jdlrm.init, cfg=jcfg,
                                    dtype=getattr(jnp, dtype))
        pb.init = functools.partial(pdlrm.init, cfg=pcfg,
                                    dtype=getattr(torch, dtype))
    return jb, pb


def _dlrm_batch(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    shp = recsys_common.RECSYS_SHAPES[shape]
    b = shp["batch"]
    idx = np.stack([rng.integers(0, v, (b, cfg.lookups))
                    for v in cfg.n_rows], axis=1).astype(np.int32)
    batch = {"dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
             "indices": idx,
             "rank_of": [rng.permutation(v).astype(np.int32)
                         for v in cfg.n_rows]}
    if shape == "train_batch":
        batch["labels"] = (rng.random(b) < 0.3).astype(np.float32)
    if shape == "retrieval_cand":
        batch["candidates"] = rng.integers(
            0, cfg.n_rows[-1], shp["n_candidates"]).astype(np.int32)
    return batch


def _run_both(jb, pb, cell, args_np, port_args=None):
    """The reference's plan fn under jax.jit and the port's on the same
    inputs (mesh None, one pod)."""
    jplan = jb.steps[cell].make_fn(jb, None, False)
    pplan = pb.steps[cell].make_fn(pb, None, False)
    want = jax.jit(jplan.fn)(*_jax_args(args_np))
    got = pplan.fn(*(port_args if port_args is not None
                     else _to_torch(args_np)))
    return _np_tree(want), got, pplan


def _check_step(want, got):
    """Loss, every updated param and every optimizer-state leaf (row-wise
    accumulators, AdamW moments and count) of a train step."""
    np.testing.assert_allclose(got[2].numpy(), want[2], **STEP_TOL)
    gflat = tree.flatten_with_path(got[:2])
    wflat = {keystr(p): x for p, x in tree_flatten_with_path(want[:2])[0]}
    assert [p for p, _ in gflat] == list(wflat)
    for path, x in gflat:
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(wflat[path], np.float32),
                                   err_msg=path, **STEP_TOL)


def test_bce_gradient_at_a_zero_logit_is_the_reference():
    """The DLRM's and DIN's loss (``common.bce_with_logits``) against the
    reference's formula, values and gradients, at logits that include
    exactly 0: there JAX's ``abs`` has slope 1 (``torch.abs`` 0), so the
    reference's gradient is ``-y``, and the port's must be too (a sample
    whose last hidden layer is dead, under zero biases, has logit 0)."""
    from repro_torch.models.common import bce_with_logits
    logits = np.array([-1.5, 0.0, 0.0, 2.0, -0.0], np.float32)
    y = np.array([0.0, 1.0, 0.0, 1.0, 1.0], np.float32)

    def ref(lg):
        return jnp.mean(jnp.maximum(lg, 0) - lg * y
                        + jnp.log1p(jnp.exp(-jnp.abs(lg))))

    want_v, want_g = jax.value_and_grad(ref)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = torch.mean(bce_with_logits(lt, torch.from_numpy(y)))
    (g,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(got.detach().numpy(), want_v, rtol=1e-7)
    # the two frameworks' exp and log1p round apart in the last bit; at
    # the kink the parting would be 0.5 / 5 = 0.1
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["serve_p99", "serve_bulk",
                                  "retrieval_cand"])
def test_dlrm_serve_plans_match_reference(small_shapes, cell, dtype):
    jb, pb = _dlrm_bundles(dtype, hybrid=True, table_2d=True)
    params = _np_tree(jb.init(jax.random.PRNGKey(0)))
    batch = _dlrm_batch(jb.cfg, cell, 1)
    want, got, _ = _run_both(jb, pb, cell, (params, batch))
    tol = SERVE_TOL if dtype == "float32" else BF16_TOL
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_dlrm_serve_plan_plain_route_equals_kernel_route(small_shapes):
    """``plain=True`` builds the same plan through the kernels' plain
    versions (the card's oracle); on the CPU both routes are the plain
    versions, so the two are equal."""
    _, pb = _dlrm_bundles()
    args = _to_torch((_np_tree(_dlrm_bundles()[0].init(
        jax.random.PRNGKey(0))), _dlrm_batch(pb.cfg, "serve_p99", 2)))
    kern = pb.steps["serve_p99"].make_fn(pb, None, False).fn(*args)
    plain = pb.steps["serve_p99"].make_fn(pb, None, False, plain=True).fn(
        *args)
    torch.testing.assert_close(kern, plain, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["dlrm-mlperf", "dlrm-rm2"])
def test_dlrm_train_step_matches_reference(small_shapes, name):
    kw = dict(hybrid=True, table_2d=True) if name == "dlrm-mlperf" else {}
    jb, pb = _dlrm_bundles(**kw)
    params = jb.init(jax.random.PRNGKey(0))
    opt = _np_tree(jb.optimizer.init(params))
    batch = _dlrm_batch(jb.cfg, "train_batch", 3)
    args = (_np_tree(params), opt, batch)
    port_opt = pb.optimizer.init(_to_torch(params))
    want, got, plan = _run_both(jb, pb, "train_batch", args,
                                (_to_torch(params), port_opt,
                                 _to_torch(batch)))
    _check_step(want, got)
    assert plan.donate == (0, 1)


def _din_batch(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    shp = recsys_common.RECSYS_SHAPES[shape]
    b = shp["batch"]
    batch = {"hist": rng.integers(0, cfg.n_items, (b, cfg.seq_len))
             .astype(np.int32),
             "hist_mask": rng.random((b, cfg.seq_len)) < 0.8,
             "profile": rng.standard_normal((b, cfg.n_profile))
             .astype(np.float32)}
    if shape == "retrieval_cand":
        batch["candidates"] = rng.integers(
            0, cfg.n_items, shp["n_candidates"]).astype(np.int32)
    else:
        batch["target"] = rng.integers(0, cfg.n_items, b).astype(np.int32)
    if shape == "train_batch":
        batch["labels"] = (rng.random(b) < 0.3).astype(np.float32)
    return batch


@pytest.fixture
def narrow_din(monkeypatch, small_shapes):
    from repro.models import din as jdin
    from repro_torch.models import din as pdin
    kw = dict(n_items=300, seq_len=12, attn_mlp=(8, 4), mlp=(16, 8))
    monkeypatch.setattr(jdin_arch, "CONFIG", jdin.DINConfig(**kw))
    monkeypatch.setattr(din_arch, "CONFIG", pdin.DINConfig(**kw))
    return jbase.get_arch("din"), configs.get_arch("din")


@pytest.mark.parametrize("cell", REC_CELLS)
def test_din_plans_match_reference(narrow_din, cell):
    jb, pb = narrow_din
    params = jb.init(jax.random.PRNGKey(0))
    batch = _din_batch(jb.cfg, cell, 4)
    if cell == "train_batch":
        opt = _np_tree(jb.optimizer.init(params))
        want, got, _ = _run_both(
            jb, pb, cell, (_np_tree(params), opt, batch),
            (_to_torch(params), pb.optimizer.init(_to_torch(params)),
             _to_torch(batch)))
        _check_step(want, got)
    else:
        want, got, _ = _run_both(jb, pb, cell, (_np_tree(params), batch))
        np.testing.assert_allclose(got.numpy(), want, **SERVE_TOL)


def _bert_batch(cfg, shape, seed, n_mask):
    rng = np.random.default_rng(seed)
    shp = recsys_common.RECSYS_SHAPES[shape]
    b, t = shp["batch"], cfg.seq_len
    pad = np.ones((b, t), bool)
    pad[: b // 2, : t // 4] = False
    batch = {"items": rng.integers(1, cfg.n_items, (b, t)).astype(np.int32),
             "pad_mask": pad}
    if shape == "train_batch":
        tmask = rng.random((b, n_mask)) < 0.9
        batch.update(
            mask_pos=np.stack([rng.choice(t, n_mask, replace=False)
                               for _ in range(b)]).astype(np.int32),
            targets=rng.integers(1, cfg.n_items, (b, n_mask))
            .astype(np.int32),
            target_mask=tmask)
    if shape == "retrieval_cand":
        batch["candidates"] = rng.integers(
            0, cfg.n_items, shp["n_candidates"]).astype(np.int32)
    return batch


@pytest.fixture
def narrow_bert(monkeypatch, small_shapes):
    from repro.models import bert4rec as jbert
    from repro_torch.models import bert4rec as pbert
    kw = dict(n_items=208, seq_len=24, embed_dim=16, d_ff=32)
    monkeypatch.setattr(jbert_arch, "CONFIG", jbert.Bert4RecConfig(**kw))
    monkeypatch.setattr(bert4rec_arch, "CONFIG", pbert.Bert4RecConfig(**kw))
    return jbase.get_arch("bert4rec"), configs.get_arch("bert4rec")


def _with_microbatch(bundle, n):
    """``bundle`` with its train cell's accumulation chunks set to ``n``."""
    step = bundle.steps["train_batch"]
    make_fn = functools.partial(step.make_fn.func,
                                **{**step.make_fn.keywords, "microbatch": n})
    return dataclasses.replace(bundle, steps={
        **bundle.steps, "train_batch": dataclasses.replace(step,
                                                           make_fn=make_fn)})


@pytest.mark.parametrize("cell", REC_CELLS)
def test_bert4rec_plans_match_reference(narrow_bert, cell):
    """The serve, retrieval and cloze train cells; the train cell with 4
    gradient-accumulation chunks (the bundle's own is 16, of a batch the
    narrow run cuts to 64), each chunk checkpointed."""
    jb, pb = narrow_bert
    params = jb.init(jax.random.PRNGKey(0))
    batch = _bert_batch(jb.cfg, cell, 5, bert4rec_arch.N_MASK)
    if cell != "train_batch":
        want, got, _ = _run_both(jb, pb, cell, (_np_tree(params), batch))
        np.testing.assert_allclose(got.numpy(), want, **SERVE_TOL)
        return
    jb, pb = _with_microbatch(jb, 4), _with_microbatch(pb, 4)
    n, b = 4, SMALL_SHAPES["train_batch"]["batch"]
    chunked = {k: (v.reshape((n, b // n) + v.shape[1:]) if v.shape[:1] ==
                   (b,) else v) for k, v in batch.items()}
    jplan = jb.steps[cell].make_fn(jb, None, False)
    assert jax.tree.map(lambda x: x.shape, jplan.args[2]) == \
        {k: v.shape for k, v in chunked.items()}
    opt = _np_tree(jb.optimizer.init(params))
    want, got, _ = _run_both(
        jb, pb, cell, (_np_tree(params), opt, chunked),
        (_to_torch(params), pb.optimizer.init(_to_torch(params)),
         _to_torch(chunked)))
    _check_step(want, got)


@pytest.fixture
def narrow_sage(monkeypatch):
    from repro.models import graphsage as jsage
    from repro_torch.models import graphsage as psage
    cfgs = {"CFG_REDDIT": dict(d_in=12, n_classes=5, fanouts=(15, 10),
                               d_hidden=16),
            "CFG_CORA": dict(d_in=10, n_classes=4, d_hidden=16),
            "CFG_PRODUCTS": dict(d_in=6, n_classes=3, d_hidden=16),
            "CFG_MOLECULE": dict(d_in=5, n_classes=2, d_hidden=16)}
    for k, kw in cfgs.items():
        monkeypatch.setattr(jsage_arch, k, jsage.SAGEConfig(**kw))
        monkeypatch.setattr(graphsage_reddit, k, psage.SAGEConfig(**kw))
    for shapes in (jsage_arch.SHAPES, graphsage_reddit.SHAPES):
        monkeypatch.setitem(shapes, "full_graph_sm",
                            dict(n_nodes=60, n_edges=200, d_feat=10))
        monkeypatch.setitem(shapes, "ogb_products",
                            dict(n_nodes=50, n_edges=256, d_feat=6))
        monkeypatch.setitem(shapes, "minibatch_lg",
                            dict(n_nodes=400, n_edges=4000, batch_nodes=32,
                                 fanouts=(15, 10)))
    return jbase.get_arch("graphsage-reddit"), \
        configs.get_arch("graphsage-reddit")


def _sage_batch(jplan, seed):
    """Random inputs of the plan's batch shapes: node indices within their
    block, masks and labels."""
    rng = np.random.default_rng(seed)
    spec = jplan.args[2]
    if "edges" in spec:                                    # molecule
        b, n = spec["x"].shape[:2]
        e = spec["edges"].shape[1]
        sizes = rng.integers(n // 2, n + 1, b)
        return {"x": rng.standard_normal(spec["x"].shape).astype(np.float32),
                "edges": np.stack([rng.integers(0, s, (e, 2))
                                   for s in sizes]).astype(np.int32),
                "edge_mask": rng.random((b, e)) < 0.9,
                "node_mask": np.arange(n)[None, :] < sizes[:, None],
                "labels": rng.integers(0, 2, b).astype(np.int32)}
    if "edge_src" in spec:                                 # full graph
        n, e = spec["feats"].shape[0], spec["edge_src"].shape[0]
        return {"feats": rng.standard_normal(spec["feats"].shape)
                .astype(np.float32),
                "edge_src": rng.integers(0, n, e).astype(np.int32),
                "edge_dst": rng.integers(0, n, e).astype(np.int32),
                "labels": rng.integers(0, 3, n).astype(np.int32),
                "train_mask": (rng.random(n) < 0.5).astype(np.float32)}
    dp, n0, _ = spec["feats"].shape                        # sampled blocks
    n1, seeds = spec["self_idx"][0].shape[1], spec["self_idx"][1].shape[1]
    return {"feats": rng.standard_normal(spec["feats"].shape)
            .astype(np.float32),
            "nbrs": [rng.integers(0, n0, x.shape).astype(np.int32)
                     if i == 0 else rng.integers(0, n1, x.shape)
                     .astype(np.int32) for i, x in enumerate(spec["nbrs"])],
            "self_idx": [rng.integers(0, n0, (dp, n1)).astype(np.int32),
                         rng.integers(0, n1, (dp, seeds)).astype(np.int32)],
            "mask": [rng.random(x.shape) < 0.8 for x in spec["mask"]],
            "labels": rng.integers(0, 5, (dp, seeds)).astype(np.int32)}


@pytest.mark.parametrize("cell", GNN_CELLS)
def test_graphsage_train_plans_match_reference(narrow_sage, cell):
    jb, pb = narrow_sage
    jplan = jb.steps[cell].make_fn(jb, None, False)
    cfg = {"full_graph_sm": "CFG_CORA", "minibatch_lg": "CFG_REDDIT",
           "ogb_products": "CFG_PRODUCTS", "molecule": "CFG_MOLECULE"}[cell]
    from repro.models import graphsage as jsage
    params = jsage.init(jax.random.PRNGKey(1), getattr(jsage_arch, cfg))
    opt = _np_tree(jb.optimizer.init(params))
    batch = _sage_batch(jplan, 6)
    want, got, _ = _run_both(
        jb, pb, cell, (_np_tree(params), opt, batch),
        (_to_torch(params), pb.optimizer.init(_to_torch(params)),
         _to_torch(batch)))
    _check_step(want, got)
