"""What ``BENCHMARK.json`` names, found by name under the benchmark's
folder: a cell's configuration (``configs/<config>.json`` through the
entry's ``file``) and the model module that the file's ``model`` key names
(``models/<model>.py``), its traffic (``traffic/<traffic>.json``) and each
metric's reader (``metrics/<metric>.py``, a module with ``read(run)`` that
returns a number, or None where it finds nothing to read).

A model module defines ``Model``, whose ``from_conf(name, conf)`` reads a
configuration file and refuses one it does not compute; the harness and
the readers ask the resulting object for everything that belongs to the
model (``models/dlrm.py`` lists what).

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

MODULE = re.compile(r"[A-Za-z_][A-Za-z0-9_]{0,63}")


def load(path: Path, mod_name: str):
    """The module in the file ``path``, loaded under ``mod_name`` (and
    entered in ``sys.modules`` under it, where a dataclass's string
    annotations are looked up while the module runs)."""
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    model: object           # the configuration's ``Model``
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

    def config(self, name: str):
        """The ``Model`` of configuration ``name``: its file read by the
        module its ``model`` key names. A file with no such key, one that
        names no module, or one its module refuses stops the run here."""
        entry = next((c for c in self.data["configs"] if c["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
        path = self.root / entry["file"]
        conf = json.loads(path.read_text())
        module = conf.get("model")
        if not isinstance(module, str) or not MODULE.fullmatch(module):
            raise ValueError(f"{path}: no \"model\" key naming a model "
                             f"module (recbench/models/<model>.py): "
                             f"{module!r}")
        file = self.dir / "models" / f"{module}.py"
        if not file.is_file():
            raise ValueError(f"{path}: model {module!r}: no {file}")
        try:
            return load(file, f"recbench_model_{module}").Model.from_conf(
                name, conf)
        except (KeyError, ValueError) as e:
            raise ValueError(f"{path}: not a {module!r} configuration: "
                             f"{e}") from e

    def cell(self, name: str) -> Cell:
        for w in self.data["workloads"]:
            if w["name"] == name:
                break
        else:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        model = self.config(w["config"])
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
        mod_name = "recbench_metric_" + "".join(
            ch if ch.isalnum() else "_" for ch in metric)
        return load(self.dir / "metrics" / f"{metric}.py", mod_name).read
