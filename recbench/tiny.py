"""A benchmark root at toy size for the CPU tests: the real metric readers
beside one tiny DLRM configuration and a bulk and an online traffic mix,
written as files, as a later change would add them.

    root = tiny.make_root(tmp_path)
    harness.run_cell(root, "tiny-bulk", seed, 0.2, False, device="cpu")
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent

CONFIG = {
    "source": "test configuration, no source", "arch": None, "n_dense": 5,
    "embed_dim": 16, "vocabs": [600, 400, 512], "lookups": 6,
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
    metric readers and the tiny configuration and traffic files."""
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    root = Path(tmp) / "root"
    shutil.copytree(HERE / "metrics", root / "recbench" / "metrics")
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
