"""A model added as files alone (``toy_concat.py``: its own module, with
another bag length in each table and the concat interaction; its
configuration, traffic and cells) runs through the harness unchanged, its
readers read through its module, and a fault in its forward is caught;
configurations that name no model, an unknown one, or an interaction their
module does not compute are refused at set-up."""

import json

import numpy as np
import pytest

from repro_torch.models import dlrm

from recbench import harness, tiny
from recbench.spec import Benchmark

SEED = 2**31 + 613
SOUND = "            z = torch.cat([x, *bags], dim=1)\n"
# the last table's bag left out
FAULT = "            z = torch.cat([x, *bags[:-1], 0 * bags[-1]], dim=1)\n"


@pytest.fixture
def root(tmp_path):
    root = tiny.make_root(tmp_path)
    tiny.add_toy(root)
    return root


@pytest.mark.parametrize("cell", list(tiny.TOY_TRAFFIC))
def test_toy_model_runs_correct(root, cell):
    r = harness.run_cell(root, cell, SEED, 0.2, False, device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["logit_err"]["value"] <= tiny.TOY["check"][
        "logit_err_limit"]


def test_toy_readers_read_through_its_module(root, monkeypatch):
    """``mfu`` and ``hot_hit_share`` in a traced run of the toy's bulk
    cell, and their values over fixed uses against the toy's own layout:
    bags of 3, 1 and 7 ids side by side in the pool's last dimension."""
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.05)
    r = harness.run_cell(root, "toy-bulk", SEED, 0.1, True, device="cpu")
    assert r["correct"]
    for name in ("mfu", "hot_hit_share"):
        assert 0 < r["metrics"][name]["value"] <= 100
    bench = Benchmark(root)
    cell = bench.cell("toy-bulk")
    _, _, dense, indices, run = harness.prepare(cell, SEED, "cpu")
    assert indices.shape == (3, 48, 11)
    run.pool_uses = np.array([1, 2, 3])
    run.samples, run.window_s = 6 * 48, 0.5
    hits = 0
    for t, (lo, hi) in enumerate([(0, 3), (3, 4), (4, 11)]):
        hot = run.params["rank_of"][t][indices[..., lo:hi].long()] \
            < run.params["hot_sizes"][t]
        hits += sum(u * int(hot[e].sum()) for e, u in enumerate([1, 2, 3]))
    assert bench.reader("hot_hit_share")(run) == pytest.approx(
        100 * hits / (6 * 48 * 11), rel=1e-12)
    # bottom 5-16-8, top 32-16-1 (32 = 8 + 3 bags of 8), 11 rows of 8 added
    flops = 2 * (5 * 16 + 16 * 8) + 2 * (32 * 16 + 16) + 11 * 8
    assert bench.reader("mfu")(run) == pytest.approx(
        100 * flops * 6 * 48 / 0.5 / 67e12, rel=1e-12)


@pytest.mark.parametrize("cell", list(tiny.TOY_TRAFFIC))
def test_fault_in_toy_forward_is_caught(tmp_path, cell):
    source = (tiny.HERE / "toy_concat.py").read_text()
    assert source.count(SOUND) == 1
    root = tiny.make_root(tmp_path)
    tiny.add_toy(root, source.replace(SOUND, FAULT))
    r = harness.run_cell(root, cell, SEED, 0.2, False, device="cpu")
    assert not r["correct"]
    assert r["checks"]["logit_err"]["value"] > tiny.TOY["check"][
        "logit_err_limit"]


REFUSED = {
    "no_model": ("tiny", {"model": None}),
    "unknown_model": ("tiny", {"model": "dcnv2"}),
    "path_as_model": ("tiny", {"model": "../metrics/mfu"}),
    "dcn_as_dlrm": ("tiny", {"interaction": "dcn"}),
    "dot_as_toy": ("toy", {"interaction": "dot"}),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_config_refused_at_setup(root, case, monkeypatch):
    """Refused by ``Benchmark.cell``, with the file's name, before any
    model is built or run."""
    name, change = REFUSED[case]
    base = tiny.CONFIG if name == "tiny" else tiny.TOY
    conf = {k: v for k, v in {**base, **change}.items() if v is not None}
    (root / "recbench" / "configs" / f"{name}.json").write_text(
        json.dumps(conf))
    calls = []
    monkeypatch.setattr(dlrm, "forward", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(harness, "prepare", lambda *a, **k: calls.append(a))
    with pytest.raises(ValueError, match=f"{name}.json"):
        harness.run_cell(root, f"{name}-bulk", SEED, 0.1, False,
                         device="cpu")
    assert not calls
