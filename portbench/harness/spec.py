"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
harness reads, for a cell:

- ``portbench/configs/<config>.json``: the configuration (the format's
  settings, the corpus parameters under ``assumed``);
- ``portbench/traffic/<traffic>.json``: the mix, whose ``op`` names the
  entry point ``portbench/entries/<op>.py``;
- ``portbench/metrics/<metric>.py`` for each metric the cell reports: its
  end-to-end metrics (every entry whose ``workloads`` lists the cell, or
  that has no ``workloads``) and, with ``--trace 1``, its per-layer metrics
  (the same rule; an entry without ``workloads`` follows the cells of the
  end-to-end metric it ``moves``).

Nothing here knows a cell, a configuration, a mix or a metric by name, so a
new one is new files and new entries only.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["ROOT", "BENCH", "NAME", "UNIT", "Cell", "load_cell",
           "load_module", "cells"]

BENCH = Path(__file__).resolve().parents[1]  # portbench/
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    """One workload with everything it needs, by value."""

    name: str
    chips: int
    config: dict
    traffic: dict
    dir: Path  # the benchmark's folder: traffic/, entries/, metrics/, ...
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cells(bench: dict) -> dict:
    """Each metric name's cells: its ``workloads``, else every cell that
    reports the end-to-end metric it moves (end-to-end: every cell)."""
    every = [w["name"] for w in bench["workloads"]]
    out = {m["name"]: m.get("workloads", every) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        out[m["name"]] = m.get("workloads", out.get(m["moves"], []))
    return out


def load_cell(workload: str, bench_path: Path | None = None) -> Cell:
    """The cell ``workload`` of ``bench_path`` (default: the repository's
    ``BENCHMARK.json``; its files are found beside it), its configuration
    and traffic read, its metrics listed; KeyError for an unknown cell,
    ValueError for a bad name."""
    bench_path = Path(bench_path or ROOT / "BENCHMARK.json")
    base = bench_path.parent
    bench = _json(bench_path)
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    for n in (cell["config"], cell["traffic"]):
        if not NAME.match(n):
            raise ValueError(f"bad name {n!r}")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _json(base / cfg_entry["file"])
    folder = base / BENCH.name
    traffic = _json(folder / "traffic" / f"{cell['traffic']}.json")
    if not NAME.match(traffic["op"]):
        raise ValueError(f"bad op {traffic['op']!r}")
    where = cells(bench)
    return Cell(
        name=workload, chips=int(cell["chips"]), config=config,
        traffic=traffic, dir=folder,
        end_to_end=[m for m in bench["end_to_end"]
                    if workload in where[m["name"]]],
        per_layer=[m for m in bench["per_layer"]
                   if workload in where[m["name"]]])
