"""The plain reference against the port's CPU route, and its control
(TF32 products) against the limit each configuration's check holds."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from recbench import harness, reference, synth, tiny, traffic
from recbench.spec import Benchmark

HERE = Path(__file__).resolve().parent


def _program_and_reference(model, seed, n_rows_pool=2):
    """The port's logits (CPU route, remapped tables) and the reference's
    for the same pool entries."""
    tr = {"pool_entries": n_rows_pool, "entry_samples": 128,
          "profile_samples": 256, "ids": {"alpha": 1.05}}
    cell = harness.Cell("t", model, "t", {**tr, "mode": "bulk"}, 1)
    cfg, weights, dense, indices, run = harness.prepare(cell, seed, "cpu")
    from repro_torch.models import dlrm
    with torch.inference_mode():
        got = torch.cat([dlrm.forward(run.params, {"dense": dense[e],
                                                   "indices": indices[e]},
                                      cfg) for e in range(n_rows_pool)])
        d, i = dense.flatten(0, 1), indices.flatten(0, 1)
        want = model.reference_logits(weights, seed, d, i)
        ctrl = model.reference_logits(weights, seed, d, i, "tf32")
    return got, want, ctrl


def _err(got, want):
    return float((got - want).abs().max() / want.pow(2).mean().sqrt())


def test_reference_matches_the_port_on_a_tiny_dlrm(tmp_path):
    model = Benchmark(tiny.make_root(tmp_path)).config("tiny")
    got, want, _ = _program_and_reference(model, 2**33 + 1)
    assert _err(got, want) < 1e-5
    # the bags move the logits: the SLS is part of what is compared
    no_bags = dataclasses.replace(model, table_scale=0.0)
    assert _err(got, _program_and_reference(no_bags, 2**33 + 1)[1]) > 0.05


ROWS = 2048


def _full_width_root(tmp_path, config):
    """A tiny root whose one configuration has ``config``'s widths, dtypes
    and lookups, on tables of ``ROWS`` rows."""
    root = tiny.make_root(tmp_path)
    b = Benchmark(HERE.parent)
    entry = next(c for c in b.data["configs"] if c["name"] == config)
    conf = json.loads((b.root / entry["file"]).read_text())
    conf["arch"] = None
    conf["source_vocabs"] = [min(v, ROWS) for v in
                             conf.get("source_vocabs", conf["vocabs"])]
    conf["vocabs"] = [ROWS] * len(conf["vocabs"])
    (root / "recbench/configs/tiny.json").write_text(json.dumps(conf))
    return root


@pytest.mark.parametrize("config", ["rmc2", "dlrm-mlperf"])
def test_control_fails_and_program_passes_at_full_width(config, tmp_path,
                                                         monkeypatch):
    """A whole run at each configuration's widths, dtypes and lookups on
    small tables: the port's CPU route is correct; the TF32 control, put
    in its place, is not, by the harness's own comparison."""
    root = _full_width_root(tmp_path, config)
    seed = 12345
    sound = harness.run_cell(root, "tiny-bulk", seed, 0.2, False,
                             device="cpu")
    assert sound["correct"]
    model = Benchmark(root).config("tiny")
    weights = model.make_weights(seed, "cpu")
    from repro_torch.models import dlrm

    def control(params, batch, cfg, *a, **k):
        return model.reference_logits(weights, seed, batch["dense"],
                                      batch["indices"], "tf32")
    monkeypatch.setattr(dlrm, "forward", control)
    r = harness.run_cell(root, "tiny-bulk", seed, 0.2, False, device="cpu")
    assert not r["correct"]
    assert r["checks"]["logit_err"]["value"] > model.logit_err_limit


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0 - 2**-12,
                      2**-20 * (1 + 2**-10)])
    want = torch.tensor([1.0, 1.0, 1.0 + 4 * 2**-11, -3.0,
                         2**-20 * (1 + 2**-10)])
    assert torch.equal(reference.round_tf32(x), want)


def test_table_rows_are_counter_based():
    rows = torch.tensor([7, 0, 999_999, 7])
    a = synth.table_rows(5, 3, rows, 16, 0.5, torch.float32)
    full = synth.make_table(5, 3, 1000, 16, 0.5, torch.float32, "cpu")
    assert torch.equal(a[0], a[3]) and torch.equal(a[1], full[0])
    assert torch.equal(a[0], full[7])
    assert float(a.abs().max()) <= 0.5
    assert not torch.equal(a, synth.table_rows(6, 3, rows, 16, 0.5,
                                               torch.float32))
    bf = synth.table_rows(5, 3, rows, 16, 0.5, torch.bfloat16)
    assert torch.equal(bf, a.to(torch.bfloat16))


def test_reference_imports_nothing_of_the_program():
    """The shared yardstick and the dlrm module load, and the module's
    reference and arithmetic run, without a module of the program."""
    code = ("import sys, torch; import recbench.reference, recbench.traffic, "
            "recbench.arith; from recbench.spec import Benchmark; "
            "m = Benchmark('.').config('rmc2'); "
            "i = torch.zeros((2, m.n_tables, m.lookups), dtype=torch.int32); "
            "m.reference_logits(m.make_weights(1, 'cpu'), 1, "
            "torch.ones((2, m.n_dense)), i); "
            "m.flops_per_sample(); m.sls_work(i); "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('repro', 'repro_torch', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=HERE.parent, check=True)
    assert out.stdout.strip() == "[]"


def test_zipf_cdf_is_a_distribution():
    cdf = traffic.zipf_cdf(100, 1.1, "cpu")
    assert cdf[-1] == 1.0 and bool((cdf[1:] >= cdf[:-1]).all())
