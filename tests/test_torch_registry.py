"""The port's arch registry (``repro_torch.configs``: ``base``, ``lm_common``
and the five LM arch modules) against the reference's
(``repro.configs``), at full size.

For each LM arch: every param leaf's PartitionSpec under ``param_rules``,
``serve_rules_2d`` and the optimizer's rules (the reference's trees through
``jax.eval_shape``, the port's on the ``meta`` device), ``_cache_specs``,
each cell plan's in/out specs and ``donate`` on one pod and on several,
the ``steps`` keys, kinds and the ``long_500k`` skip, and ``model_flops``
(rtol 1e-12). Building all fifteen plans allocates no real tensor. The
completeness checks mirror ``tests/test_registry.py:18-50`` for the LM
entries.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from jax.tree_util import keystr, tree_flatten_with_path
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import base as jbase
from repro.configs import lm_common as jlm_common
from repro_torch import configs, tree
from repro_torch.configs import base, lm_common
from repro_torch.distributed.shardings import make_param_specs

LM_ARCHS = ["qwen3-1.7b", "qwen2-0.5b", "nemotron-4-15b",
            "qwen3-moe-30b-a3b", "deepseek-v3-671b"]
LM_STEPS = {"train_4k", "prefill_32k", "decode_32k", "long_500k"}
CELLS = ["train_4k", "prefill_32k", "decode_32k"]


def _jax_specs(specs) -> dict:
    """{keystr path: spec entries} of a reference spec tree."""
    flat = tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))
    return {keystr(p): tuple(s) for p, s in flat[0]}


def _port_specs(specs) -> dict:
    return {p: tuple(s) for p, s in tree.flatten_with_path(specs)}


@pytest.fixture(scope="module")
def bundles():
    return {n: (jbase.get_arch(n), base.get_arch(n)) for n in LM_ARCHS}


@pytest.fixture(scope="module")
def plans(bundles):
    """Every cell plan of every arch on one pod and on several, from both
    registries (mesh None: a plan's specs do not depend on it)."""
    out = {}
    for name, (jb, pb) in bundles.items():
        for cell in CELLS:
            for multi_pod in (False, True):
                out[name, cell, multi_pod] = (
                    jb.steps[cell].make_fn(jb, None, multi_pod),
                    pb.steps[cell].make_fn(pb, None, multi_pod))
    return out


def test_list_archs_is_the_lm_half():
    """The port registers the five LM archs, each of which the reference
    registers too, and with the recsys half (``test_torch_registry_recsys
    .py``) the reference's whole list; an unknown name raises."""
    assert set(LM_ARCHS) <= set(configs.list_archs())
    assert configs.list_archs() == jbase.list_archs()
    assert [n for n in configs.list_archs()
            if configs.get_arch(n).family == "lm"] == sorted(LM_ARCHS)
    with pytest.raises(KeyError):
        configs.get_arch("dlrm-rm3")


@pytest.mark.parametrize("name", LM_ARCHS)
def test_bundle_matches_reference(bundles, name):
    jb, pb = bundles[name]
    assert isinstance(pb, configs.ArchBundle)
    assert (pb.name, pb.family, pb.notes) == (jb.name, jb.family, jb.notes)
    assert dataclasses.asdict(pb.cfg) == dataclasses.asdict(jb.cfg)
    assert pb.cfg is configs.LM_ARCHS[name]
    assert set(pb.steps) == set(jb.steps) == LM_STEPS
    for shape, step in pb.steps.items():
        ref = jb.steps[shape]
        assert (step.kind, step.skip, step.donate, step.static,
                step.batch_arg_axes) == (ref.kind, ref.skip, ref.donate,
                                         ref.static, ref.batch_arg_axes)
        if step.skip:
            assert shape == "long_500k" and "full-attention" in step.skip
            assert step.skip == base.LONG_500K_SKIP == jbase.LONG_500K_SKIP
        else:
            assert callable(step.make_fn)
    assert sorted(pb.model_flops) == sorted(jb.model_flops)
    for shape, flops in jb.model_flops.items():
        np.testing.assert_allclose(pb.model_flops[shape], flops, rtol=1e-12)
    assert callable(pb.init) and pb.optimizer is not None
    assert base.lm_shapes() == jbase.lm_shapes()


@pytest.mark.parametrize("name", LM_ARCHS)
def test_param_serve_and_opt_rules_match_reference(bundles, plans, name):
    """Every leaf's spec under the param rules (with and without FSDP on
    several pods), the 2D serving rules, and the optimizer's (its state
    specs from the train plan)."""
    import jax
    jb, pb = bundles[name]
    jp = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0)))
    pp = pb.init(0, device="meta")
    cases = [(jb.param_rules, pb.param_rules),
             (jlm_common.serve_rules_2d(jb.cfg),
              lm_common.serve_rules_2d(pb.cfg)),
             (jlm_common.lm_param_rules(jb.cfg, True, ("pod", "data")),
              lm_common.lm_param_rules(pb.cfg, True, ("pod", "data")))]
    for jrules, prules in cases:
        want = _jax_specs(jlm_common.make_param_specs(jp, jrules))
        assert _port_specs(make_param_specs(pp, prules)) == want
    assert (jb.opt_rules is None) == (pb.opt_rules is None)
    for multi_pod in (False, True):
        jplan, pplan = plans[name, "train_4k", multi_pod]
        assert _port_specs(pplan.in_specs[1]) == \
            _jax_specs(jplan.in_specs[1])


@pytest.mark.parametrize("name", LM_ARCHS)
def test_cache_specs_match_reference(bundles, name):
    jb, pb = bundles[name]
    for axes in (("data",), ("pod", "data")):
        assert _port_specs(lm_common._cache_specs(pb.cfg, axes)) == \
            _jax_specs(jlm_common._cache_specs(jb.cfg, axes))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", LM_ARCHS)
def test_plan_specs_match_reference(plans, name, cell, multi_pod):
    """Each plan's in/out specs and donate; its args have the reference's
    shapes and dtypes, on the meta device, but for the optimizer's float
    state, which the port keeps in float32 (``repro_torch.optim``)."""
    jplan, pplan = plans[name, cell, multi_pod]
    assert pplan.donate == jplan.donate
    assert _port_specs(pplan.in_specs) == _jax_specs(jplan.in_specs)
    assert _port_specs(pplan.out_specs) == _jax_specs(jplan.out_specs)

    def opt_float(path, dtype):
        return cell == "train_4k" and path.startswith("[1]") \
            and "float" in dtype

    got = {p: (tuple(x.shape), str(x.dtype).split(".")[-1], x.device.type)
           for p, x in tree.flatten_with_path(pplan.args)}
    want = {keystr(p): (tuple(x.shape), str(x.dtype), "meta")
            for p, x in tree_flatten_with_path(jplan.args)[0]}
    want = {p: (s, "float32" if opt_float(p, dt) else dt, dev)
            for p, (s, dt, dev) in want.items()}
    assert got == want


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
    """All fifteen plans at full size (deepseek-v3's 671B params, their
    optimizer states and 32k caches) are built on the meta device: no op
    makes a real tensor, and every argument is meta."""
    with _RealTensors() as mode:
        built = [configs.get_arch(n).steps[c].make_fn(
            configs.get_arch(n), None, False) for n in LM_ARCHS
            for c in CELLS]
    assert mode.real == []
    assert len(built) == 15
    n_params = 0
    for plan in built:
        leaves = tree.leaves(plan.args)
        assert leaves and all(x.device.type == "meta" for x in leaves)
        n_params = max(n_params, sum(x.numel() for x in
                                     tree.leaves(plan.args[0])))
    assert n_params > 670e9                 # deepseek-v3 is there


def test_plan_fn_runs_on_real_tensors():
    """A plan's fn runs a cut model on real tensors without a mesh: the
    prefill and decode plans of qwen3-1.7b at two layers and narrow width
    give the model's own prefill and decode_step."""
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.QWEN3_1_7B, n_layers=2, d_model=64,
                              n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                              vocab=256)
    bundle = dataclasses.replace(configs.get_arch("qwen3-1.7b"), cfg=cfg)
    params = lm.init(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 9),
                         generator=torch.Generator().manual_seed(0))
    prefill = lm_common.build_prefill_plan(bundle, None, False).fn
    decode = lm_common.build_decode_plan(bundle, None, False).fn
    with torch.no_grad():
        logits, cache = prefill(params, toks[:, :8])
        want, wcache = lm.prefill(params, toks[:, :8], cfg)
        torch.testing.assert_close(logits, want, rtol=0, atol=0)
        grow = {k: torch.nn.functional.pad(v, [0, 0, 0, 0, 0, 1])
                for k, v in cache.items()}
        wgrow = {k: torch.nn.functional.pad(v, [0, 0, 0, 0, 0, 1])
                 for k, v in wcache.items()}
        got, _ = decode(params, grow, toks[:, 8], length=8)
        want, _ = lm.decode_step(params, wgrow, toks[:, 8], 8, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
