"""``BENCHMARK.json`` keeps the contract's form; what it names is found
by name; a cell, a configuration, a traffic mix and a metric added as
files need no edit; the command refuses to run without a card; nothing
the harness loads is JAX's or the JAX package's."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from recbench import harness, tiny
from recbench.spec import Benchmark

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["recbench"]
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["source"])
        assert c["file"].startswith("recbench/")
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert (HERE / "models" / f"{conf['model']}.py").is_file()
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"setup_s", "p95_ms", "inferences_per_s"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    for c in cells:      # each cell: setup_s, another end-to-end metric,
        got = {m["name"] for m in Benchmark(ROOT).metrics(c, False)}
        assert "setup_s" in got and len(got) >= 2   # and a per-layer one
        assert Benchmark(ROOT).metrics(c, True)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_everything_named_is_found():
    b = Benchmark(ROOT)
    for w in BENCH["workloads"]:
        cell = b.cell(w["name"])
        assert cell.traffic["mode"] in ("bulk", "online")
        cell.model.port_config()            # the registry's sizes, dtype
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(b.reader(m["name"]))


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell, a metric and a model module,
    each added as a file (and an entry of BENCHMARK.json), run with no
    other change."""
    root = tiny.make_root(tmp_path)
    rb = root / "recbench"
    conf = json.loads((rb / "configs" / "tiny.json").read_text())
    (rb / "configs" / "tiny2.json").write_text(
        json.dumps({**conf, "vocabs": [300, 700]}))
    mix = {**tiny.TRAFFIC["tiny-bulk"], "entry_samples": 32}
    (rb / "traffic" / "bulk-32.json").write_text(json.dumps(mix))
    (rb / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return run.steps\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny2", "source": "test",
                             "file": "recbench/configs/tiny2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny2-bulk", "config": "tiny2",
                               "traffic": "bulk-32", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "steps_seen", "unit": "steps",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny2-bulk"]})
    for m in bench["end_to_end"]:
        if m["name"] == "inferences_per_s":
            m["workloads"].append("tiny2-bulk")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run_cell(root, "tiny2-bulk", 17, 0.2, False, device="cpu")
    assert r["correct"]
    assert set(r["metrics"]) == {"setup_s", "inferences_per_s",
                                 "steps_seen"}
    assert r["metrics"]["steps_seen"]["value"] * 32 == r["attempted"]
    # a model of another layout: its module, configuration and cells
    tiny.add_toy(root)
    r = harness.run_cell(root, "toy-bulk", 17, 0.2, False, device="cpu")
    assert r["correct"] and set(r["metrics"]) == {"setup_s",
                                                  "inferences_per_s"}
    assert Benchmark(root).cell("toy-bulk").model.lookups == (3, 1, 7)


def _run(cwd, *args):
    return subprocess.run([sys.executable, "recbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120)


ARGS = ("--workload", "rmc2-bulk-k0", "--seed", str(2**31 + 3), "--seconds",
        "1", "--trace", "0")


def test_refuses_without_a_card_or_the_program(tmp_path):
    """Without a card (or with fewer than the cell asks for) and in a
    directory holding only BENCHMARK.json and recbench/, the command exits
    with another code than 0 and prints no result."""
    import torch
    if not torch.cuda.is_available():
        r = _run(ROOT, *ARGS)
        assert r.returncode != 0 and r.stdout == ""
    alone = tmp_path / "alone"
    shutil.copytree(HERE, alone / "recbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    r = _run(alone, *ARGS)
    assert r.returncode != 0 and r.stdout == ""


def test_no_jax_in_a_whole_run():
    """A whole run, every metric reader included, loads no module whose
    top-level name is jax, jaxlib, flax or repro (repro_torch is not one)."""
    code = f"""
import sys, tempfile
from pathlib import Path
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from recbench import harness, tiny
root = tiny.make_root(Path(tempfile.mkdtemp()))
harness.TRACE_SECONDS = 0.05
for cell in tiny.TRAFFIC:
    harness.run_cell(root, cell, 5, 0.1, True, device="cpu")
import recbench.run, recbench.sweep
print(harness.foreign_modules(), "repro_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "flax.nn",
                                  "repro", "repro.models.dlrm"])
def test_foreign_modules_are_seen(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, object())
    assert name in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert "repro_torch_extra" not in harness.foreign_modules()
