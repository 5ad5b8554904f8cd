"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration, whose ``file``
is ``cfbench/configs/<config>.json`` with its code beside it
(``<config>.py``), and its traffic mix, ``cfbench/traffic/<traffic>.json``.
The numbers its check compares, with their limits, are in
``cfbench/workloads/<cell>.json``; each metric's reader is
``cfbench/metrics/<metric>.py``.  Adding a cell, a configuration or a
metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, List

HERE = Path(__file__).resolve().parent


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    module: Any
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def readers(self, trace: bool) -> list:
        """(metric entry, its reader module) of the metrics this cell reports
        in a run with ``--trace`` ``trace``."""
        return [(m, load_module(HERE / "metrics" / f"{m['name']}.py", f"cfbench_metric_{m['name']}"))
                for m in (self.per_layer if trace else self.end_to_end)]


def load_spec(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_cell(root: Path, name: str) -> Cell:
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(cells)})")
    w = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg_path = Path(root) / config["file"]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(
        name=name, chips=w["chips"], cfg=json.loads(cfg_path.read_text()),
        module=load_module(cfg_path.with_suffix(".py"), f"cfbench_config_{w['config'].replace('-', '_')}"),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((HERE / "workloads" / f"{name}.json").read_text())["limits"],
        end_to_end=e2e, per_layer=per_layer)
