"""What ``BENCHMARK.json`` names, found by name under the benchmark's
folder: a cell's configuration (``configs/<config>.json`` through the
entry's ``file``), its traffic (``traffic/<traffic>.json``) and each metric's
reader (``metrics/<metric>.py``, a module with ``read(run)`` that returns a
number, or None where it finds nothing to read).

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Model:
    """A DLRM configuration as its file states it. ``bot_mlp`` and
    ``top_mlp`` are layer widths with the input and the output; the top
    MLP's input width is derived from the interaction. ``id_rows`` is the
    file's ``source_vocabs`` where its stored ``vocabs`` are padded beyond
    them, else ``vocabs``."""

    name: str
    arch: str | None          # the port's registry name, checked against
    n_dense: int
    embed_dim: int
    vocabs: tuple
    lookups: int
    bot_mlp: tuple
    top_mlp: tuple
    table_dtype: torch.dtype
    mlp_dtype: torch.dtype
    table_scale: float        # logical rows are uniform in [-s, s)
    logit_err_limit: float    # the check's limit (PERF.md says from what)
    id_rows: tuple            # rows a table's ids are drawn over

    @property
    def n_tables(self) -> int:
        return len(self.vocabs)

    @property
    def top_in(self) -> int:
        n = self.n_tables + 1
        return self.embed_dim + n * (n - 1) // 2

    @classmethod
    def from_file(cls, name: str, path: Path) -> "Model":
        c = json.loads(path.read_text())
        return cls(name=name, arch=c.get("arch"), n_dense=c["n_dense"],
                   embed_dim=c["embed_dim"], vocabs=tuple(c["vocabs"]),
                   lookups=c["lookups"], bot_mlp=tuple(c["bot_mlp"]),
                   top_mlp=tuple(c["top_mlp"]),
                   table_dtype=DTYPES[c["table_dtype"]],
                   mlp_dtype=DTYPES[c["mlp_dtype"]],
                   table_scale=float(c["table_scale"]),
                   logit_err_limit=float(c["check"]["logit_err_limit"]),
                   id_rows=tuple(c.get("source_vocabs", c["vocabs"])))


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    model: Model
    traffic_name: str
    traffic: dict
    chips: int


class Benchmark:
    """``BENCHMARK.json`` at ``root``, with the files its names point to
    under ``root / 'recbench'``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "recbench"

    def cell(self, name: str) -> Cell:
        for w in self.data["workloads"]:
            if w["name"] == name:
                break
        else:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in self.data["configs"]
                    if c["name"] == w["config"])
        model = Model.from_file(conf["name"], self.root / conf["file"])
        traffic = json.loads(
            (self.dir / "traffic" / f"{w['traffic']}.json").read_text())
        return Cell(name, model, w["traffic"], traffic, int(w["chips"]))

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end ones, or
        with ``trace`` its per-layer ones (those that list it, or list no
        cells)."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """``read`` of ``metrics/<metric>.py``."""
        path = self.dir / "metrics" / f"{metric}.py"
        mod_name = "recbench_metric_" + "".join(
            ch if ch.isalnum() else "_" for ch in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
