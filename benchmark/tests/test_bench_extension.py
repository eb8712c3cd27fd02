"""A later change adds a configuration, a traffic mix, a kind of scene and a
per-layer metric as new files and new entries of ``BENCHMARK.json``, and
edits no file the benchmark has: in a copy of the folder, a temporary
configuration, traffic file, scene generator, limits file and metric
reader are picked up by name."""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402
from benchmark import spec, traffic  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

PROBE = '''"""A metric a later change adds: calls of the traced window."""


def read(ctx):
    return float(ctx.window["calls"])
'''


SCENE = '''"""A scene a later change adds: horizontal colour stripes, one
foreground class an image."""

import numpy as np


def pool(traffic, r):
    b, crop = traffic["batch"], traffic["crop"]
    out = []
    for _ in range(traffic["pool"]):
        rows = r.integers(0, 256, size=(b, crop, 1, 3), dtype=np.uint8)
        labels = np.zeros((b, traffic["num_fg"]), np.float32)
        labels[np.arange(b), r.integers(0, traffic["num_fg"], size=b)] = 1.0
        out.append({"images": np.ascontiguousarray(
                        np.broadcast_to(rows, (b, crop, crop, 3))),
                    "cls_label": labels,
                    "img_box": np.tile(np.asarray([traffic["img_box"]],
                                                  np.int32), (b, 1))})
    return out
'''


def _digests(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    root = tiny.make_root(tmp_path, "pseudo_label")
    (root / "benchmark" / "metrics" / "tiny_probe.py").write_text(PROBE)
    (root / "benchmark" / "traffic" / "tiny_stripes.py").write_text(SCENE)
    mix = root / "benchmark" / "traffic" / "tiny.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   scene="tiny_stripes")))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "tiny_probe", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "program entry", "moves": "img_s",
        "workloads": ["tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    before = _digests(ROOT / "benchmark")
    after = _digests(root / "benchmark")
    added = set(after) - set(before)
    assert added == {"configs/tiny.json", "traffic/tiny.json",
                     "traffic/tiny_stripes.py", "limits/tiny.json",
                     "metrics/tiny_probe.py"}
    assert all(after[k] == v for k, v in before.items())

    cell = spec.resolve("tiny", root=root)
    assert cell.config["name"] == "tiny" and cell.traffic["crop"] == 64
    images = traffic.generate(cell.traffic, 9, root)[0]["images"]
    assert (images == images[:, :, :1]).all()        # the new scene's
    line, _ = bench_run.run_cell(cell, 9, 0.05, True, torch.device("cpu"),
                                 t_start=time.perf_counter())
    assert line["metrics"]["tiny_probe"]["value"] >= cell.traffic["pool"]
    assert line["metrics"]["tiny_probe"]["unit"] == "calls"
