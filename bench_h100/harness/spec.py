"""Cells, configurations, traffic mixes and metrics, found by name.

``BENCHMARK.json`` at the checkout's root lists them; each has a file of
its own under this folder, found by its name alone, so that a cell or a
metric is added by adding files and entries, never by editing one:

* a configuration ``<config>``: ``configs/<config>.json`` (its parameters,
  its program under ``programs/``, its guarantee and the limits of the
  comparison);
* a traffic mix ``<traffic>``: ``traffic/<traffic>.json`` (batch, dp, the
  inputs' pool), read by the one generator in ``cell.py``;
* a metric ``<name>``: the reader ``metrics/<name>.py``, or for a metric
  split by the end-to-end metric it moves (``pad_share.tput``) the reader of
  the part before the first dot, ``metrics/<base>.py``.  A reader defines
  ``read(run) -> float | None`` (None: nothing to read in this run).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["HERE", "ROOT", "Cell", "load_benchmark", "load_cell",
           "metric_reader", "cell_metrics"]

HERE = Path(__file__).resolve().parents[1]       # the benchmark's folder
ROOT = HERE.parent                               # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(kind: str, name: str, here: Path) -> dict:
    path = here / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path.relative_to(here.parent)}")
    with open(path) as f:
        data = json.load(f)
    data.setdefault("name", name)
    return data


def load_cell(name: str, bench: dict | None = None,
              here: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic files; KeyError when any is missing."""
    bench = load_benchmark(here.parent) if bench is None else bench
    for w in bench["workloads"]:
        if w["name"] == name:
            return Cell(name, int(w["chips"]),
                        _load_json("configs", w["config"], here),
                        _load_json("traffic", w["traffic"], here))
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def metric_reader(name: str, here: Path = HERE):
    """The ``read`` function of metric ``name`` (see the module's doc)."""
    for stem in (name, name.split(".")[0]):
        path = here / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"bench_h100_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise KeyError(f"no reader metrics/{name}.py or metrics/"
                   f"{name.split('.')[0]}.py")
