"""The port's launch tooling: ``launch.op_stats`` (mirroring
``tests/test_hlo_stats.py``'s cases in torch terms), its flops against the
reference's ``hlo_stats`` on the same plans, ``launch.roofline``'s H100
terms, and ``launch.dryrun`` on the fake production meshes.

The collective cases run on a fake process group of 8 ranks
(``distributed.mesh.init("meta")``), started and destroyed in-process.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jbase
from repro.configs import dlrm_mlperf as jmlperf
from repro.launch.hlo_stats import hlo_stats
from repro_torch import configs, tree
from repro_torch.configs import dlrm_mlperf, lm_common
from repro_torch.distributed import mesh as M
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_stats import op_stats

ROOT = Path(__file__).resolve().parents[1]
FLOPS_RTOL = 1e-6


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def fake_group():
    """A fake process group of 8 ranks (this process rank 0) and a (8,)
    mesh on it; destroyed after the test."""
    M.init("meta", rank=0, world_size=8)
    try:
        yield M.make_mesh((8,), ("d",), "meta")
    finally:
        dist.destroy_process_group()


class TestFlopsCounting:
    def test_single_matmul(self):
        s = op_stats(lambda x, w: x @ w, _meta(64, 128), _meta(128, 32))
        assert s["flops"] == 2 * 64 * 128 * 32

    def test_loop_multiplies_by_trip_count(self):
        def f(x, w):
            for _ in range(12):
                x = torch.tanh(x @ w)
            return x

        s = op_stats(f, _meta(32, 64), _meta(64, 64))
        assert s["flops"] == 12 * 2 * 32 * 64 * 64

    def test_nested_loops_multiply(self):
        def f(x):
            for _ in range(5):
                for _ in range(3):
                    x = torch.tanh(x @ x)
            return x

        s = op_stats(f, _meta(16, 16))
        assert s["flops"] == 15 * 2 * 16 ** 3

    def test_bytes_nonzero_and_scale(self):
        one = op_stats(lambda x: (x + 1.0) * 2.0, _meta(1024, 1024))
        assert one["bytes"] >= 2 * 1024 * 1024 * 4     # read + write once
        four = op_stats(lambda x: (x + 1.0) * 2.0, _meta(2048, 1024))
        assert four["bytes"] == 2 * one["bytes"]
        views = op_stats(lambda x: x.T[:5].unsqueeze(0), _meta(64, 64))
        assert views["bytes"] == 0

    def test_backward_counts_its_products(self):
        """A train step's backward runs under the counter too: x @ w's two
        gradient products (only w's here, x needs none)."""
        def f(x, w):
            w = w.detach().requires_grad_()
            (g,) = torch.autograd.grad((x @ w).sum(), w)
            return g

        s = op_stats(f, _meta(64, 128), _meta(128, 32))
        assert s["flops"] == 2 * (2 * 64 * 128 * 32)

    def test_peak_counts_arguments_and_what_was_alive(self):
        x = _meta(1024, 256)                                 # 1 MiB
        s = op_stats(lambda x: (x + 1.0) + 2.0, x)
        assert s["argument_bytes"] == 1024 * 256 * 4
        # x, x + 1 and the sum alive at once at most
        assert s["peak_bytes"] == 3 * 1024 * 256 * 4


class TestCollectives:
    def test_psum_wire_bytes(self, fake_group):
        s = op_stats(lambda x: M.psum(x, fake_group, "d"), _meta(1024),
                     mesh=fake_group)
        ar = s["per_op"]["all-reduce"]
        assert ar["count"] == 1
        assert ar["wire_bytes"] == 2 * 1024 * 4 * 7 / 8
        assert s["total"]["wire_bytes"] == ar["wire_bytes"]

    def test_collective_inside_loop_multiplied(self, fake_group):
        def f(x):
            for _ in range(6):
                x = M.psum(x, fake_group, "d") * 0.125
            return x

        s = op_stats(f, _meta(256), mesh=fake_group)
        ar = s["per_op"]["all-reduce"]
        assert ar["count"] == 6
        assert ar["wire_bytes"] == 6 * 2 * 256 * 4 * 7 / 8

    def test_allgather_and_reduce_scatter(self, fake_group):
        s = op_stats(lambda x: M.all_gather(x, fake_group, "d"), _meta(128),
                     mesh=fake_group)
        ag = s["per_op"]["all-gather"]
        assert ag["count"] == 1 and ag["result_bytes"] == 8 * 128 * 4
        assert ag["wire_bytes"] == 8 * 128 * 4 * 7 / 8
        s = op_stats(lambda x: M.psum_scatter(x, fake_group, "d"),
                     _meta(1024), mesh=fake_group)
        rs = s["per_op"]["reduce-scatter"]
        assert rs["result_bytes"] == 128 * 4
        assert rs["wire_bytes"] == 1024 * 4 * 7 / 8


# -- flops against the reference's hlo_stats ------------------------------


def test_dlrm_serve_plan_flops_equal_hlo_stats():
    """A narrow DLRM serve plan: the MLPs' products and the interaction's
    Gram (2 B T^2 D, the reference's einsum and the plain fused
    interaction's bmm); the SLS is gathers and adds on both sides."""
    kw = dict(name="narrow", dim=16, bot=(13, 64, 16), top=(64, 32, 1),
              vocabs=[512, 1024, 512], lookups=4)
    jb = jmlperf.make_dlrm_bundle("narrow", jmlperf.make_config(**kw))
    pb = dlrm_mlperf.make_dlrm_bundle("narrow",
                                      dlrm_mlperf.make_config(**kw))
    jplan = jb.steps["serve_p99"].make_fn(jb, None, False)
    compiled = jax.jit(jplan.fn).lower(*jplan.args).compile()
    want = hlo_stats(compiled.as_text(), 1)["flops"]
    pplan = pb.steps["serve_p99"].make_fn(pb, None, False)
    got = op_stats(pplan.fn, *pplan.args)["flops"]
    b, t, d = 512, 4, 16
    assert want >= 2 * b * t * t * d
    np.testing.assert_allclose(got, want, rtol=FLOPS_RTOL)


def test_lm_prefill_plan_flops_equal_hlo_stats():
    """A narrow dense LM's prefill within one attention chunk (no causal
    block skipped on either side): every projection, the attention's two
    products and the head."""
    from repro.models import lm as jlm
    from repro_torch.models import lm as plm
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
              d_ff=128, vocab=256)
    jb = jbase.get_arch("qwen3-1.7b")
    jcfg = dataclasses.replace(jb.cfg, **kw)
    jb = dataclasses.replace(jb, cfg=jcfg,
                             init=functools.partial(jlm.init, cfg=jcfg))
    pb = configs.get_arch("qwen3-1.7b")
    pcfg = dataclasses.replace(pb.cfg, **kw)
    pb = dataclasses.replace(pb, cfg=pcfg,
                             init=functools.partial(plm.init, cfg=pcfg))
    seq = min(pcfg.q_chunk, pcfg.kv_chunk)
    jplan = jb.steps["prefill_32k"].make_fn(jb, None, False)
    pplan = pb.steps["prefill_32k"].make_fn(pb, None, False)
    jtok = jax.ShapeDtypeStruct((2, seq), jax.numpy.int32)
    compiled = jax.jit(jplan.fn).lower(jplan.args[0], jtok).compile()
    want = hlo_stats(compiled.as_text(), 1)["flops"]
    got = op_stats(pplan.fn, pplan.args[0], _meta(2, seq,
                                                  dtype=torch.int32))["flops"]
    np.testing.assert_allclose(got, want, rtol=FLOPS_RTOL)


# -- roofline and dry-run -------------------------------------------------


def test_analyze_gives_h100_terms_and_bottleneck():
    stats = {"flops": 989e12, "bytes": 6.7e12,
             "total": {"wire_bytes": 45e9}, "per_op": {},
             "argument_bytes": 10, "peak_bytes": 81e9}
    r = rl.analyze(stats, 256, model_flops=256 * 989e12 / 2)
    assert (r.t_compute, r.t_memory, r.t_collective) == pytest.approx(
        (1.0, 2.0, 0.1))
    assert r.bottleneck == "memory" and r.t_bound == pytest.approx(2.0)
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.roofline_fraction() == pytest.approx(0.25)
    assert r.memory == {"argument_bytes": 10, "peak_bytes": int(81e9),
                        "fits_hbm": False}
    slow = rl.analyze(stats, 256, model_flops=256 * 989e12 / 2,
                      hw={**rl.H100, "peak_flops": 989e12 / 2})
    assert slow.roofline_fraction() == pytest.approx(0.5)
    d = r.to_dict()
    assert d["t_bound"] == pytest.approx(2.0) and "roofline_fraction" in d
    assert rl.H100 == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                       "link_bw": 450e9, "hbm_bytes": 80e9}


def test_dryrun_cli_runs_single_pod(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch dlrm-rm2,qwen3-1.7b
    --mesh single``: every cell of both archs on the 16 x 16 fake mesh
    runs (``long_500k`` skipped), each record with H100 roofline terms and
    a peak, and the run exits 0."""
    out = tmp_path / "dry.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "dlrm-rm2,qwen3-1.7b", "--mesh", "single", "--jobs", "2", "--out",
         str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    recs = json.loads(out.read_text())
    assert {(x["arch"], x["shape"]) for x in recs} == {
        ("dlrm-rm2", c) for c in ("train_batch", "serve_p99", "serve_bulk",
                                  "retrieval_cand")} | {
        ("qwen3-1.7b", c) for c in ("train_4k", "prefill_32k", "decode_32k",
                                    "long_500k")}
    for x in recs:
        assert x["mesh"] == "16x16"
        if x["shape"] == "long_500k":
            assert x["status"] == "skip"
            continue
        assert x["status"] == "ok"
        roof = x["roofline"]
        assert roof["flops_per_device"] > 0 and roof["t_bound"] > 0
        assert roof["memory"]["fits_hbm"] is True
    assert "7 ok / 1 skip / 0 fail" in r.stdout


@pytest.mark.parametrize("name", ["din", "bert4rec"])
def test_dryrun_counts_item_row_blocks(name):
    """DIN's and BERT4Rec's dry-run rows on the 16 x 16 mesh count the
    reference's layout: rank 0 holds a 1/16 row block of ``items`` (and of
    its row-wise accumulator in the train cell), the MLPs whole, and every
    serve cell puts the masked lookups' sums (and BERT4Rec's score
    gather) on the wire."""
    M.init("meta", rank=0, world_size=256)
    try:
        mesh = make_production_mesh(device="meta")
        bundle = configs.get_arch(name)
        n, d = bundle.cfg.n_items, bundle.cfg.embed_dim
        for shape, step in bundle.steps.items():
            plan = step.make_fn(bundle, mesh, False)
            assert plan.layout is None
            blocks = dryrun.rank_blocks(mesh, plan.args, plan.local_specs())
            assert tuple(blocks[0]["items"].shape) == (n // 16, d)
            if step.kind == "train":
                acc = blocks[1]["table"]["['items']"]
                assert tuple(acc.shape) == (n // 16,)
            rec = dryrun.run_cell(bundle, shape, mesh, False)
            assert rec["status"] == "ok", rec
            wire = rec["roofline"]["wire_bytes_per_device"]
            assert wire > 0, (shape, wire)
    finally:
        dist.destroy_process_group()


def test_every_cell_builds_its_plan_on_the_fake_production_mesh():
    """Every non-skipped (arch x shape) builds its plan on the fake 256-rank
    mesh, with one spec per argument leaf and a block for rank 0 (the
    cheap structural check in front of the full dry-run)."""
    M.init("meta", rank=0, world_size=256)
    try:
        mesh = make_production_mesh(device="meta")
        n = 0
        for name in configs.list_archs():
            bundle = configs.get_arch(name)
            for step in bundle.steps.values():
                if step.skip:
                    continue
                plan = step.make_fn(bundle, mesh, False)
                blocks = dryrun.rank_blocks(mesh, plan.args,
                                            plan.local_specs())
                assert tree.leaves(blocks) and all(
                    x.device.type == "meta" for x in tree.leaves(blocks))
                n += 1
    finally:
        dist.destroy_process_group()
    assert n >= 47      # 35 assigned + 12 rmc cells


def test_kernel_wrappers_give_shapes_on_meta():
    """Each kernel entry on meta tensors runs its plain version's shapes
    (what the dry-run counts); nothing is launched."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dot_interaction import dot_interaction_fused
    from repro_torch.kernels.recflash_sls import recflash_sls_grouped
    ids = _meta(4, 2, 3, dtype=torch.int32)
    got = [ops.dot_interaction_fused(_meta(4, 8), _meta(4, 3, 8)),
           ops.dot_interaction(_meta(4, 5, 8)),
           ops.recflash_sls_grouped([_meta(10, 8), _meta(12, 8)], [1, 1], ids,
                                    [_meta(10, dtype=torch.int32),
                                     _meta(12, dtype=torch.int32)]),
           ops.recflash_sls(_meta(1, 8), _meta(9, 8),
                            _meta(4, 3, dtype=torch.int32), block_b=1)]
    assert [(tuple(x.shape), x.device.type) for x in got] == [
        ((4, 14), "meta"), ((4, 10), "meta"), ((4, 2, 8), "meta"),
        ((4, 8), "meta")]
    assert dot_interaction_fused.launches == 0
    assert recflash_sls_grouped.launches == 0
