"""The port's serving path against the reference's, on the CPU.

The request stream and the offline remap must equal the reference
``Deployment``'s for the same arch, seed and rate; the batches must equal
the reference ``DynamicBatcher``'s; the whole path must run end to end on
``--device cpu``. A subprocess checks that neither the port nor
``chip_smoke.py`` loads JAX or any ``repro`` module.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.embedding.layout import RemapSpec as JaxRemapSpec
from repro.serving import (BatcherConfig, Deployment, DeploymentConfig,
                           DynamicBatcher, RequestQueue)
from repro_torch.configs import arch_model_config
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]


def _reference(arch, rows, seed=0, k=0.0):
    return Deployment(DeploymentConfig.from_arch(arch, n_rows=rows, seed=seed,
                                                 k=k))


@pytest.mark.parametrize("arch,rows,arrival,seed", [
    ("dlrm_small", 1000, "poisson", 0),
    ("rmc1", 2000, "bursty", 3),
])
def test_stream_and_remap_match_deployment(arch, rows, arrival, seed):
    dep = _reference(arch, rows, seed=seed)
    want = dep.stream(60, 5000.0, arrival=arrival)
    cfg = arch_model_config(arch, n_rows=rows)
    got = serve.make_stream(cfg, 60, 5000.0, arrival=arrival, seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert (g.rid, g.arrival_us) == (w.rid, w.arrival_us)
        np.testing.assert_array_equal(g.tables, w.tables)
        np.testing.assert_array_equal(g.rows, w.rows)
    for spec, stats in zip(serve.offline_specs(cfg, seed=seed), dep.stats,
                           strict=True):
        ref = JaxRemapSpec.from_counts(stats.counts)
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
    got = serve.form_batches(reqs, max_batch, max_wait_us)
    assert [[r.rid for r in b.requests] for b in got] == \
        [[r.rid for r in b.requests] for b in want]
    assert [b.dispatch_us for b in got] == [b.dispatch_us for b in want]


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


def test_cpu_skips_compute_for_large_tables(capsys):
    res = serve.serve(arch="dlrm_rm2", requests=4, device="cpu")
    assert res.params is None and res.n_scored == 0 and res.batches
    assert "compute skipped" in capsys.readouterr().out


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
