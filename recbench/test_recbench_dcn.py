"""DLRM-DCNv2 in the benchmark (``models/dlrm_dcn.py``, its configuration
``dlrm-dcnv2``, the reader ``dcn_roofline``): a tiny configuration of the
module added as files runs ``correct`` through the port's CPU route, bulk
and online; its readers read through the module; a forward with a cross
layer dropped, and the TF32 control at the published widths, are caught by
the harness's own comparison; the module's reference bags are the port's
bit for bit."""

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.models import dlrm

from recbench import arith, harness, spans, tiny
from recbench.devtrace import DeviceTrace
from recbench.spec import Benchmark

SEED = 2**31 + 977
ROOT = tiny.HERE.parent
DCN = {
    "model": "dlrm_dcn", "port_module": None, "interaction": "dcn",
    "n_dense": 5, "embed_dim": 8, "vocabs": [300, 200, 500, 100],
    "lookups": [3, 1, 7, 2], "bot_mlp": [5, 16, 8], "top_mlp": [16, 1],
    "dcn_layers": 2, "dcn_rank": 4, "table_dtype": "float32",
    "mlp_dtype": "float32", "reduced": [], "check": {"logit_err_limit": 1e-4},
}
CELLS = {"dcn-bulk": "tiny-bulk", "dcn-online": "tiny-online"}


def add_dcn(root, conf=None):
    """Add to ``root``, as a file and entries of its ``BENCHMARK.json``,
    the configuration ``dcn`` (``conf``, or the tiny one) of the real
    ``dlrm_dcn`` module and a cell on each tiny traffic mix, reporting what
    the tiny cell of the same mode reports, and ``dcn_roofline`` in bulk."""
    rb = root / "recbench"
    (rb / "configs" / "dcn.json").write_text(json.dumps(conf or DCN))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dcn", "source": "test",
                             "file": "recbench/configs/dcn.json",
                             "reduced": [], "why": "test"})
    for cell, mix in CELLS.items():
        bench["workloads"].append({"name": cell, "config": "dcn",
                                   "traffic": mix, "chips": 1,
                                   "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "dcn_roofline":
            m["workloads"] = ["dcn-bulk"]
        elif "workloads" in m:
            m["workloads"] += [c for c, mix in CELLS.items()
                               if mix in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def root(tmp_path):
    root = tiny.make_root(tmp_path)
    add_dcn(root)
    return root


@pytest.mark.parametrize("cell", list(CELLS))
def test_dcn_runs_correct(root, cell):
    r = harness.run_cell(root, cell, SEED, 0.2, False, device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["logit_err"]["value"] <= DCN["check"][
        "logit_err_limit"]
    want = {"setup_s", "inferences_per_s"} if cell == "dcn-bulk" else \
        {"setup_s", "p95_ms"}
    assert set(r["metrics"]) == want


def test_dcn_readers(root, monkeypatch):
    """In a traced bulk run on the CPU, ``mfu`` and ``hot_hit_share`` read
    a number and the device-trace readers none; over fixed uses their
    values follow the module's layout and FLOPs."""
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.05)
    r = harness.run_cell(root, "dcn-bulk", SEED, 0.1, True, device="cpu")
    assert r["correct"]
    for name in ("mfu", "hot_hit_share"):
        assert 0 < r["metrics"][name]["value"] <= 100
    for name in ("sls_roofline", "dcn_roofline", "interact_ms.bulk"):
        assert name not in r["metrics"]      # no device trace on the CPU
    bench = Benchmark(root)
    _, _, dense, indices, run = harness.prepare(bench.cell("dcn-bulk"),
                                                SEED, "cpu")
    assert indices.shape == (3, 64, 13)
    run.pool_uses = np.array([2, 0, 1])
    run.samples, run.window_s = 3 * 64, 0.25
    hits = 0
    for t, (lo, hi) in enumerate([(0, 3), (3, 4), (4, 11), (11, 13)]):
        hot = run.params["rank_of"][t][indices[..., lo:hi].long()] \
            < run.params["hot_sizes"][t]
        hits += sum(u * int(hot[e].sum()) for e, u in enumerate([2, 0, 1]))
    assert bench.reader("hot_hit_share")(run) == pytest.approx(
        100 * hits / (3 * 64 * 13), rel=1e-12)
    # bottom 5-16-8, cross 2 x (4 x 40 x 4 + 3 x 40) over 40 = 5 x 8,
    # top 40-16-1, 13 rows of 8 added
    flops = 2 * (5 * 16 + 16 * 8) + 2 * (4 * 40 * 4 + 120) \
        + 2 * (40 * 16 + 16) + 13 * 8
    assert run.cell.model.flops_per_sample() == flops
    assert bench.reader("mfu")(run) == pytest.approx(
        100 * flops * 3 * 64 / 0.25 / 67e12, rel=1e-12)


def _run(model, trace, b=64):
    return types.SimpleNamespace(
        trace=trace, mode="bulk", cell=types.SimpleNamespace(model=model),
        pool_indices=torch.zeros((3, b, 1), dtype=torch.int32))


def _trace(steps=2):
    """Two steps, each a forward whose interaction launched one operation
    (100 ns on the device) beside one outside it."""
    host, ops = [], []
    for k in range(steps):
        t = 10_000 * k
        host += [(spans.FORWARD, t, t + 1000),
                 (spans.INTERACT, t + 100, t + 500),
                 ("cudaLaunchKernel", t + 200, t + 210),
                 ("cudaLaunchKernel", t + 600, t + 610)]
        ops += [("cross", t + 2000, t + 2100), ("top", t + 2100, t + 2400)]
    return DeviceTrace(1.0, steps, np.array([1, 1, 0]),
                       [n for n, _, _ in ops],
                       np.array([s for _, s, _ in ops], dtype=np.int64),
                       np.array([e for _, _, e in ops], dtype=np.int64),
                       sorted(host, key=lambda h: h[1]))


def test_dcn_roofline_on_a_hand_built_trace(tmp_path):
    root = tiny.make_root(tmp_path)
    add_dcn(root)
    bench = Benchmark(root)
    model = bench.config("dcn")
    read = bench.reader("dcn_roofline")
    flops, n_bytes = model.cross_work()
    assert flops == 2 * (4 * 40 * 4 + 3 * 40)
    assert n_bytes == 8 * 4 + 4 * 8 * 4 + 40 * 4 + 2 * (3 * 40 * 4 + 2 * 4 * 4)
    samples = 2 * 64
    bound, _ = arith.bound_s(n_bytes * samples, flops * samples)
    assert read(_run(model, _trace())) == pytest.approx(
        100 * bound / 200e-9, rel=1e-12)
    # None: a model without a cross network, no trace, no span
    assert read(_run(bench.config("tiny"), _trace())) is None
    assert read(_run(model, None)) is None
    t = _trace()
    t.host = [h for h in t.host if h[0] != spans.FORWARD]
    assert read(_run(model, t)) is None


def test_the_real_configuration_is_the_ports():
    from repro_torch.configs import dlrm_dcnv2
    model = Benchmark(ROOT).config("dlrm-dcnv2")
    assert model.port_config() == dlrm_dcnv2.CONFIG
    assert model.top_in == 3456 and sum(model.lookups) == 214
    assert model.flops_per_sample() == 32_119_424
    assert model.cross_work()[0] == 21_264_768
    # 66% of the multiply-adds are the cross network's products
    assert 3 * 2 * 3456 * 512 / (model.flops_per_sample() / 2) > 0.66


def test_a_file_that_differs_from_the_port_module_is_refused(tmp_path):
    root = tiny.make_root(tmp_path)
    conf = json.loads((ROOT / "recbench/configs/dlrm-dcnv2.json").read_text())
    add_dcn(root, {**conf, "dcn_rank": 256})
    with pytest.raises(ValueError, match="differ"):
        Benchmark(root).config("dcn").port_config()


@pytest.mark.parametrize("change", [{"interaction": "dot"},
                                    {"lookups": [3, 1, 7]},
                                    {"bot_mlp": [5, 16, 4]}])
def test_config_refused_at_setup(tmp_path, change):
    root = tiny.make_root(tmp_path)
    add_dcn(root, {**DCN, **change})
    with pytest.raises(ValueError, match="dcn.json"):
        harness.run_cell(root, "dcn-bulk", SEED, 0.1, False, device="cpu")


def test_a_dropped_cross_layer_is_caught(root, monkeypatch):
    cross_net = dlrm.cross_net
    monkeypatch.setattr(dlrm, "cross_net",
                        lambda layers, x0: cross_net(layers[:-1], x0))
    r = harness.run_cell(root, "dcn-bulk", SEED, 0.2, False, device="cpu")
    assert not r["correct"]
    assert r["checks"]["logit_err"]["value"] > DCN["check"][
        "logit_err_limit"]


def test_reference_bags_are_the_ports_bit_for_bit(tmp_path):
    """The module's reference bags (rows regenerated, added in lookup
    order) against the port's SLS over the remapped program, in bf16."""
    root = tiny.make_root(tmp_path)
    add_dcn(root, {**DCN, "table_dtype": "bfloat16"})
    cell = Benchmark(root).cell("dcn-bulk")
    cfg, _, _, indices, run = harness.prepare(cell, SEED, "cpu")
    idx = indices[1]
    got = dlrm.bags(run.params, idx, lookups=cfg.bag_lengths)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), cell.model.bags(SEED, idx))


ROWS = 2048


def test_control_fails_and_program_passes_at_full_width(tmp_path,
                                                         monkeypatch):
    """A whole run at dlrm-dcnv2's widths, dtypes and bag lengths on
    tables of at most 2,048 rows: the port's CPU route is correct; the TF32
    control (the module's reference with TF32 products), put in its place,
    is not, by the harness's own comparison: at these widths its error
    reads above the file's limit, which it would not at the tiny one."""
    conf = json.loads((ROOT / "recbench/configs/dlrm-dcnv2.json").read_text())
    conf = {**conf, "port_module": None,
            "vocabs": [min(v, ROWS) for v in conf["vocabs"]]}
    root = tiny.make_root(tmp_path)
    add_dcn(root, conf)
    sound = harness.run_cell(root, "dcn-bulk", SEED, 0.2, False,
                             device="cpu")
    assert sound["correct"]
    model = Benchmark(root).config("dcn")
    weights = model.make_weights(SEED, "cpu")

    def control(params, batch, cfg, *a, **k):
        return model.reference_logits(weights, SEED, batch["dense"],
                                      batch["indices"], "tf32")
    monkeypatch.setattr(dlrm, "forward", control)
    r = harness.run_cell(root, "dcn-bulk", SEED, 0.2, False, device="cpu")
    assert not r["correct"]
    assert r["checks"]["logit_err"]["value"] > model.logit_err_limit
    assert sound["checks"]["logit_err"]["value"] < model.logit_err_limit / 10


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, torch; from recbench.spec import Benchmark; "
            "m = Benchmark('.').config('dlrm-dcnv2'); "
            "i = torch.zeros((2, 214), dtype=torch.int32); "
            "w = m.make_weights(1, 'cpu'); "
            "m.reference_logits(w, 1, torch.ones((2, m.n_dense)), i); "
            "m.flops_per_sample(); m.sls_work(i); m.cross_work(); "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('repro', 'repro_torch', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, check=True)
    assert out.stdout.strip() == "[]"
