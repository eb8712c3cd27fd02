"""The comparison that decides ``correct`` fails what it must: with each
cell's own limits, on a tiny copy of the cell run past the look for a card
(``run_cell`` on the CPU), a sound run comes out correct, and the cell's
control and each fault that the cell can have come out not correct.

The controls: for a configuration in bf16, the program's own int8 path
(``quantized_inference``) and the reference computed in float8 e4m3 put in
the program's place; for the int8 configuration, the reference with int4
products put in the program's place.  The faults
(``benchmark/faults.py``), planted in the timed path under the harness: an
answer altered where it is produced (the CRF's logits a class off),
the CRF skipped, and half of the batch left out.  A step that returns its
state unchanged and the exchange between chips do not exist in these
one-card inference cells."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import faults, readings, spec  # noqa: E402
from benchmark import run as bench_run  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

CELLS = {"label-voc-bf16": ("pseudo_label", False),
         "label-voc-int8": ("pseudo_label", True),
         "segment-voc-bf16": ("serving", False)}


def _cell(tmp_path, workload):
    entry, quantized = CELLS[workload]
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{workload}.json")
                        .read_text())["limits"]
    root = tiny.make_root(tmp_path, entry, quantized, limits=limits)
    return spec.resolve("tiny", root=root)


def _run(cell, seed=21, **kw):
    line, worst = bench_run.run_cell(cell, seed, 0.05, False,
                                     torch.device("cpu"),
                                     t_start=time.perf_counter(), **kw)
    return line["correct"], worst


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_sound_run_is_correct(tmp_path, workload):
    ok, worst = _run(_cell(tmp_path, workload))
    assert ok, worst


CONTROLS = [(w, c) for w, (_, q) in sorted(CELLS.items())
            for c in (("int4",) if q else ("program-int8", "fp8"))]


@pytest.mark.parametrize("workload,control", CONTROLS)
def test_the_control_is_not_correct(tmp_path, workload, control):
    cell = _cell(tmp_path, workload)
    if control == "program-int8":
        ok, worst = _run(cell, quantized=True)
    else:
        got = readings.reference_control(cell, 21, torch.device("cpu"),
                                         control)
        ok, worst = got["correct"], got["numbers"]
    assert not ok, worst


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_each_fault_is_not_correct(tmp_path, workload, fault):
    cell = _cell(tmp_path, workload)
    with faults.plant(fault, CELLS[workload][0]):
        ok, worst = _run(cell)
    assert not ok, worst
