"""A tiny cell for the CPU tests: the configuration's file at
``test_tiny_patch16`` (32 wide, 4 blocks, 2 heads), the traffic at batch 2,
crop 64, a pool of 2; and a copy of the benchmark that holds them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
TRAFFIC = {"pseudo_label": "label-b64", "serving": "segment-b64"}
LIMITS = {"pseudo_label": "label-voc-bf16", "serving": "segment-voc-bf16"}


def config(quantized: bool = False) -> dict:
    with open(BENCH / "configs" / "dupl-vitb16-voc.json") as f:
        c = json.load(f)
    c.update(name="tiny", embed_dim=32, depth=4, num_heads=2, mlp_dim=128,
             quantized_inference=quantized)
    c["port"] = dict(c["port"], backbone="test_tiny_patch16")
    return c


def traffic(entry: str) -> dict:
    with open(BENCH / "traffic" / f"{TRAFFIC[entry]}.json") as f:
        t = json.load(f)
    t.update(batch=2, crop=64, pool=2, img_box=[4, 60, 2, 62])
    return t


def make_root(dest: Path, entry: str = "pseudo_label",
              quantized: bool = False, limits=None) -> Path:
    """A copy of the benchmark under ``dest`` with the tiny cell ``tiny``
    added as new files and entries (the limits of the matching full-size
    cell unless ``limits`` is given)."""
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    b = dest / "benchmark"
    (b / "configs" / "tiny.json").write_text(json.dumps(config(quantized)))
    (b / "traffic" / "tiny.json").write_text(json.dumps(traffic(entry)))
    if limits is None:
        with open(b / "limits" / f"{LIMITS[entry]}.json") as f:
            limits = json.load(f)["limits"]
    (b / "limits" / "tiny.json").write_text(json.dumps({"limits": limits}))
    bench["configs"].append({"name": "tiny", "source": "tiny test size",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "tiny", "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "CPU tests"})
    like = LIMITS[entry]
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m and like in m["workloads"]:
            m["workloads"].append("tiny")
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest
