"""``BENCHMARK.json`` and the files a cell is made of, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix:

* the configuration's file is the ``file`` of its entry in ``configs``
  (``benchmark/configs/<name>.json``): the sizes as they are run and the
  plain reference module (``benchmark/reference/<reference>.py``);
* the traffic mix is ``benchmark/traffic/<traffic>.json``: parameters that
  ``benchmark/traffic.py`` turns into inputs, and the entry of the program
  they drive (``benchmark/entries/<entry>.py``);
* each metric with a reader is ``benchmark/metrics/<name>.py``;
* the limits of the numbers that decide ``correct`` are
  ``benchmark/limits/<workload>.json``.

Adding a cell therefore adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict          # the configuration's file
    config_entry: dict    # its entry in BENCHMARK.json
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]
    root: Path

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell called ``workload`` with every file it names read; raises
    ``KeyError`` for an unknown cell and ``FileNotFoundError`` for a file
    that is missing."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / "benchmark"
    limits_path = bench_dir / "limits" / f"{workload}.json"
    return Cell(
        workload=w, config=_read_json(root / entry["file"]),
        config_entry=entry,
        traffic=_read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        limits=_read_json(limits_path)["limits"],
        root=root)


def load_module(path: Path, name: Optional[str] = None):
    """The Python file ``path`` as a module (names with dots or dashes
    included)."""
    mod_name = name or "benchmark_file_" + "".join(
        ch if ch.isalnum() else "_" for ch in str(path.relative_to(
            path.parents[2])))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(cell: Cell, name: str):
    """The reader of per-layer metric ``name``: ``read(ctx)`` of
    ``benchmark/metrics/<name>.py``."""
    return load_module(cell.root / "benchmark" / "metrics" / f"{name}.py").read


def entry_module(cell: Cell):
    """``benchmark/entries/<entry>.py`` of the cell's traffic."""
    return load_module(cell.root / "benchmark" / "entries"
                       / f"{cell.traffic['entry']}.py")


def reference_module(cell: Cell):
    """``benchmark/reference/<reference>.py`` of the cell's configuration."""
    return load_module(cell.root / "benchmark" / "reference"
                       / f"{cell.config['reference']}.py")
