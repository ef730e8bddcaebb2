"""A benchmark root at toy size for the CPU tests: the real metric readers
and model modules beside one tiny DLRM configuration and a bulk and an
online traffic mix, written as files, as a later change would add them.

    root = tiny.make_root(tmp_path)
    harness.run_cell(root, "tiny-bulk", seed, 0.2, False, device="cpu")
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent

CONFIG = {
    "model": "dlrm", "source": "test configuration, no source", "arch": None,
    "n_dense": 5, "embed_dim": 16, "vocabs": [600, 400, 512], "lookups": 6,
    "bot_mlp": [5, 32, 16], "top_mlp": [32, 16, 1], "interaction": "dot",
    "table_dtype": "float32", "mlp_dtype": "float32",
    "table_scale": 0.7071067811865476, "reduced": [],
    "check": {"logit_err_limit": 1e-4},
}
IDS = {"dist": "zipf", "alpha": 1.1}
TRAFFIC = {
    "tiny-bulk": {"mode": "bulk", "pool_entries": 3, "entry_samples": 64,
                  "profile_samples": 512, "ids": IDS},
    "tiny-online": {"mode": "online", "rate_rps": 2000, "max_batch": 8,
                    "max_wait_us": 500, "pool_entries": 96,
                    "entry_samples": 1, "profile_samples": 512, "ids": IDS},
}


def make_root(tmp: Path, bench: dict | None = None) -> Path:
    """A checkout-like root under ``tmp``: ``BENCHMARK.json`` (the real
    one's metrics, the tiny cells) and ``recbench/`` with the real
    metric readers and model modules and the tiny configuration and
    traffic files."""
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    root = Path(tmp) / "root"
    for sub in ("metrics", "models"):
        shutil.copytree(HERE / sub, root / "recbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "recbench" / "configs").mkdir()
    (root / "recbench" / "traffic").mkdir()
    (root / "recbench" / "configs" / "tiny.json").write_text(
        json.dumps(CONFIG))
    for name, t in TRAFFIC.items():
        (root / "recbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
    if bench is None:
        bench = {**real, "configs": [
            {"name": "tiny", "source": "test", "reduced": [],
             "file": "recbench/configs/tiny.json", "why": "test"}],
                 "workloads": [{"name": n, "config": "tiny", "traffic": n,
                                "chips": 1, "why": "test"}
                               for n in TRAFFIC]}
        # each metric goes to the tiny cell of the mode whose real cells
        # report it
        for kind in ("end_to_end", "per_layer"):
            for m in bench[kind]:
                if "workloads" in m:
                    m["workloads"] = [c for c in TRAFFIC if any(
                        c.split("-")[1] in w for w in m["workloads"])]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


# a model of another layout, for the tests that add a model as files:
# ``toy_concat.py`` beside this file, another bag length in each table
TOY = {
    "model": "toy_concat", "interaction": "concat", "n_dense": 5,
    "embed_dim": 8, "vocabs": [300, 200, 500], "lookups": [3, 1, 7],
    "bot_mlp": [5, 16, 8], "top_mlp": [16, 1], "table_scale": 0.5,
    "hot_frac": 0.05, "check": {"logit_err_limit": 1e-4},
}
TOY_TRAFFIC = {
    "toy-bulk": {**TRAFFIC["tiny-bulk"], "entry_samples": 48},
    "toy-online": {**TRAFFIC["tiny-online"], "rate_rps": 1500},
}


def add_toy(root: Path, source: str | None = None) -> None:
    """Add to ``root``, as files and entries of its ``BENCHMARK.json``,
    the toy model's module (``source``, or ``toy_concat.py``), its
    configuration ``toy``, its traffic and a cell of each mix, reporting
    what the tiny cell of the same mode reports."""
    rb = Path(root) / "recbench"
    (rb / "models" / "toy_concat.py").write_text(
        source or (HERE / "toy_concat.py").read_text())
    (rb / "configs" / "toy.json").write_text(json.dumps(TOY))
    for name, t in TOY_TRAFFIC.items():
        (rb / "traffic" / f"{name}.json").write_text(json.dumps(t))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "test",
                             "file": "recbench/configs/toy.json",
                             "reduced": [], "why": "test"})
    for name in TOY_TRAFFIC:
        bench["workloads"].append({"name": name, "config": "toy",
                                   "traffic": name, "chips": 1,
                                   "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c for c in TOY_TRAFFIC
                               if c.replace("toy", "tiny") in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
