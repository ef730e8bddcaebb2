"""The port's serving path against the reference's, on the CPU.

The deployment's request stream and offline remap must equal the reference
``Deployment``'s for the same arch, seed and rate; the port's batcher must
form the reference ``DynamicBatcher``'s batches; ``serve`` must score
exactly the batches of the reference's recflash lane, and ``main`` print
the reference serve's report lines; the whole path must run end to end on
``--device cpu``. A subprocess checks that neither the port nor
``chip_smoke.py`` loads JAX or any ``repro`` module.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.launch.serve as reference_serve
from repro.embedding.layout import RemapSpec as JaxRemapSpec
from repro.serving import (BatcherConfig, Deployment, DeploymentConfig,
                           DynamicBatcher, RequestQueue)
from repro_torch import serving as port_serving
from repro_torch.embedding.layout import RemapSpec
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]


def _reference(arch, rows, seed=0, k=0.0, **overrides):
    return Deployment(DeploymentConfig.from_arch(arch, n_rows=rows, seed=seed,
                                                 k=k, **overrides))


@pytest.mark.parametrize("arch,rows,arrival,seed", [
    ("dlrm_small", 1000, "poisson", 0),
    ("rmc1", 2000, "bursty", 3),
])
def test_stream_and_remap_match_deployment(arch, rows, arrival, seed):
    dep = _reference(arch, rows, seed=seed)
    want = dep.stream(60, 5000.0, arrival=arrival)
    port = port_serving.Deployment(port_serving.DeploymentConfig.from_arch(
        arch, n_rows=rows, seed=seed))
    got = port.stream(60, 5000.0, arrival=arrival)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert (g.rid, g.arrival_us) == (w.rid, w.arrival_us)
        np.testing.assert_array_equal(g.tables, w.tables)
        np.testing.assert_array_equal(g.rows, w.rows)
    for stats, ref_stats in zip(port.stats, dep.stats, strict=True):
        spec = RemapSpec.from_counts(stats.counts)
        ref = JaxRemapSpec.from_counts(ref_stats.counts)
        np.testing.assert_array_equal(spec.perm, ref.perm)
        assert spec.hot_size == ref.hot_size


@pytest.mark.parametrize("max_batch,max_wait_us", [(64, 1000.0), (8, 50.0),
                                                   (1, 0.0)])
def test_batches_match_reference_batcher(max_batch, max_wait_us):
    dep = _reference("dlrm_small", 1000)
    reqs = dep.stream(200, 20000.0, arrival="bursty")
    queue = RequestQueue(reqs)
    batcher = DynamicBatcher(BatcherConfig(max_batch, max_wait_us))
    want = []
    while (b := batcher.next_batch(queue)) is not None:
        want.append(b)
    port_queue = port_serving.RequestQueue(reqs)
    port_batcher = port_serving.DynamicBatcher(
        port_serving.BatcherConfig(max_batch, max_wait_us))
    got = []
    while (b := port_batcher.next_batch(port_queue)) is not None:
        got.append(b)
    assert [[r.rid for r in b.requests] for b in got] == \
        [[r.rid for r in b.requests] for b in want]
    assert [b.dispatch_us for b in got] == [b.dispatch_us for b in want]


@pytest.mark.parametrize("rate,sizes", [
    (20000.0, [22, 64, 64, 50]),     # backlogged: batches wait for the lane
    (2000.0, None),
])
def test_serve_scores_the_recflash_lane_batches(rate, sizes):
    want = _reference("dlrm_small", 1000, batcher=BatcherConfig(64, 1000.0))
    lane = want.run_stream(want.stream(200, rate))["recflash"].batches
    if sizes is not None:
        assert [b.size for b in lane] == sizes
    res = serve.serve(arch="dlrm_small", requests=200, rows=1000, batch=64,
                      rate=rate, device="cpu")
    assert [[r.rid for r in b.requests] for b in res.batches] == \
        [[r.rid for r in b.requests] for b in lane]
    assert res.n_scored == 200 and len(res.inputs) == len(lane)
    for inp, b in zip(res.inputs, lane, strict=True):
        rows = np.stack([r.rows.reshape(8, 20) for r in b.requests])
        np.testing.assert_array_equal(inp["indices"][:b.size].numpy(), rows)


def _report_block(out: str) -> list[str]:
    """The report lines of a serve's output, header to the end, with the
    header's wall-clock seconds masked."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.endswith("wall):"))
    return [re.sub(r"simulated in [0-9.]+s wall", "simulated in Ts wall", ln)
            for ln in lines[start:]]


@pytest.mark.parametrize("flags", [
    ["--requests", "120", "--rows", "2000"],
    ["--requests", "150", "--rows", "1500", "--part", "QLC", "--channels",
     "2", "--arrival", "bursty", "--rate", "5000", "--batch", "16"],
])
def test_main_report_matches_reference(flags, capsys, monkeypatch):
    argv = ["--skip-compute", *flags]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
    assert reference_serve.main() == 0
    want = _report_block(capsys.readouterr().out)
    assert serve.main(argv) == 0
    got = _report_block(capsys.readouterr().out)
    assert len(want) >= 5 and got == want


def test_serve_end_to_end_on_cpu():
    res = serve.serve(arch="dlrm_small", requests=40, rows=500, batch=16,
                      rate=20000.0, device="cpu")
    assert res.n_scored == 40
    assert [lg.shape[0] for lg in res.logits] == [b.size
                                                  for b in res.batches]
    assert all(bool(torch.isfinite(lg).all()) for lg in res.logits)
    assert all(inp["indices"].shape == (16, 8, 20)
               and inp["dense"].shape == (16, 13) for inp in res.inputs)
    # hot_frac 0.002 of 500 rows rounds to 1 hot row per table
    assert res.params["tables"][0].shape == (500, 64)
    assert res.params["hot_sizes"] == [1] * 8


def test_main_prints_the_reference_line(capsys):
    assert serve.main(["--rows", "300", "--requests", "12",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "scored 12 requests in" in out and "ms/batch forward" in out


def test_cpu_skips_compute_for_large_tables(capsys, monkeypatch):
    # a dlrm_rm2 deployment takes most of a minute to build on the CPU, so
    # the limit is lowered below dlrm_small's 2 MiB of tables instead
    monkeypatch.setattr(serve, "CPU_TABLE_GIB_LIMIT", 1e-3)
    res = serve.serve(arch="dlrm_small", rows=1000, requests=4,
                      device="cpu")
    assert res.params is None and res.n_scored == 0 and res.batches
    assert "compute skipped" in capsys.readouterr().out


def test_skip_compute_needs_no_card():
    res = serve.serve(requests=20, rows=500, skip_compute=True)
    assert res.params is None and res.n_scored == 0
    assert list(res.traces) == ["recssd", "rmssd", "recflash"]


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        serve.serve(requests=4, rows=100)


def test_no_jax_and_no_reference_modules_loaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.launch.serve' in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
