"""The harness on the CPU: every cell resolves to its files, the traffic is
seeded and keeps PAR's class budget, ``BENCHMARK.json`` keeps its form, a
run without a card prints no result and exits non-zero, the no-JAX check
compares top-level names whole, the trace arithmetic, and a whole run of a
tiny cell (``run_cell`` past the look for a card).  The tests marked
``cuda`` run the tiny cell on a card and skip without one."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import nojax, spec, trace, traffic  # noqa: E402
from benchmark import run as bench_run  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _bench() -> dict:
    return spec.load_benchmark()


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_benchmark()["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    cell = spec.resolve(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert (ROOT / "benchmark" / "reference"
            / f"{cell.config['reference']}.py").exists()
    assert hasattr(spec.entry_module(cell), "Entry")
    assert callable(spec.reference_module(cell).pseudo_label)
    for m in cell.per_layer:
        assert callable(spec.metric_reader(cell, m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_benchmark_json_keeps_its_form():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1:] == [
        "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_traffic_is_seeded():
    t = json.loads((ROOT / "benchmark/traffic/label-b64.json").read_text())
    t = dict(t, batch=4, crop=64, pool=3)
    big = 2 ** 31 + 12345
    a, b = traffic.generate(t, big), traffic.generate(t, big)
    c = traffic.generate(t, big + 1)
    for x, y in zip(a, b):
        for k in x:
            assert x[k].tobytes() == y[k].tobytes()
    assert a[0]["images"].tobytes() != c[0]["images"].tobytes()
    traffic.generate(t, -3)                    # any whole number
    assert traffic.check_sample(t, big) == traffic.check_sample(t, big)


@pytest.mark.parametrize("name", ["label-b64", "segment-b64"])
def test_no_image_passes_the_class_budget(name):
    t = json.loads((ROOT / f"benchmark/traffic/{name}.json").read_text())
    budget = json.loads((ROOT / "benchmark/configs/dupl-vitb16-voc.json")
                        .read_text())["par"]["class_budget"]
    lo, hi = t["classes_per_image"]
    for seed in (0, 1, 2 ** 31 + 99):
        for batch in traffic.generate(dict(t, crop=64), seed):
            n = (batch["cls_label"] > 0).sum(-1)
            assert n.min() >= lo and n.max() <= hi and n.max() + 1 <= budget
            assert batch["images"].dtype == np.uint8
            assert batch["img_box"].tolist()[0] == t["img_box"]


def test_check_sample_draws_from_the_seed():
    t = {"batch": 16, "pool": 4, "check_images": 8}
    s = traffic.check_sample(t, 7)
    assert len(s) == 8 and s == sorted(s)
    assert traffic.check_sample(dict(t, check_images=0), 7) == [
        (i, j) for i in range(4) for j in range(16)]
    two = traffic.check_sample(dict(t, check_batches=2), 7)
    assert len(two) == 8 and two == sorted(two)
    assert len({i for i, _ in two}) <= 2
    assert two == traffic.check_sample(dict(t, check_batches=2), 7)
    assert {i for i, _ in traffic.check_sample(
        dict(t, check_batches=2, check_images=0), 7)} == {i for i, _ in two}


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "label-voc-bf16",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_nojax_compares_top_level_names_whole():
    assert nojax.found(["dupl_tpu.ops.attention", "numpy"]) == ["dupl_tpu"]
    assert nojax.found(["dupl_tpu_torch", "dupl_tpu_torch.ops"]) == []
    assert nojax.found(["jax.numpy", "jaxlib", "flax.linen", "optax"]) == [
        "flax", "jax", "jaxlib", "optax"]
    assert nojax.found(["jaxtyping", "flaxen"]) == []


def test_a_run_with_jax_loaded_is_refused():
    code = ("import runpy, sys, types; sys.modules['dupl_tpu'] = "
            "types.ModuleType('dupl_tpu'); sys.argv = ['run.py', "
            "'--workload', 'label-voc-bf16', '--seed', '1', '--seconds', "
            "'1', '--trace', '0']; runpy.run_path('benchmark/run.py', "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout.strip() == ""
    assert "dupl_tpu" in out.stderr


def test_the_benchmark_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run, "
            "benchmark.spec, benchmark.trace, benchmark.counts, "
            "benchmark.program, benchmark.weights, benchmark.traffic, "
            "benchmark.readings; import dupl_tpu_torch.engine.export; "
            "print(' '.join(sys.modules))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout.split()
    assert nojax.found(out) == []


def test_test_file_names_are_not_those_of_tests():
    ours = {p.name for p in (ROOT / "benchmark" / "tests").glob("test_*.py")}
    theirs = {p.name for p in (ROOT / "tests").glob("test_*.py")}
    assert ours and not ours & theirs


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 7, "args": args}


def test_trace_arithmetic():
    ev = [
        _ev("user_annotation", trace.WINDOW, 0, 100),
        _ev("cpu_op", "dupl::exp_attention", 10, 5,
            **{"Input Dims": [[2, 130, 12, 64]] * 3}),
        _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=1),
        _ev("cpu_op", "aten::item", 40, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 72, 1, correlation=2),
        _ev("kernel", "attn_fwd_kernel<1>", 20, 10, correlation=1),
        _ev("kernel", "other_kernel", 25, 10, correlation=2),
        _ev("gpu_memcpy", "Memcpy HtoD", 80, 5),
    ]
    t0, t1 = trace.window(ev)
    assert (t0, t1) == (0.0, 100.0)
    assert trace.busy_intervals(ev, t0, t1) == [(20.0, 35.0), (80.0, 85.0)]
    ops, kerns = trace.op_kernels(ev, "dupl::exp_attention")
    assert len(ops) == 1 and [k["name"] for k in kerns] == [
        "attn_fwd_kernel<1>"]
    gaps = dict(trace.idle_gaps(ev, t0, t1))
    assert gaps["aten::item"] == pytest.approx(45e-6)     # 35 -> 80
    assert sum(gaps.values()) == pytest.approx(80e-6)   # 100 - 20
    assert trace.top_kernels(ev, t0, t1)[0][1] == pytest.approx(1e-5)
    assert trace.op_kernels([e for e in ev if e["cat"] != "cuda_runtime"],
                            "dupl::exp_attention") is None


@pytest.mark.parametrize("entry", ["pseudo_label", "serving"])
@pytest.mark.parametrize("trace_on", [False, True])
def test_a_tiny_run_on_the_cpu(tmp_path, entry, trace_on):
    root = tiny.make_root(tmp_path, entry)
    cell = spec.resolve("tiny", root=root)
    line, worst = bench_run.run_cell(cell, 2 ** 31 + 3, 0.05, trace_on,
                                     torch.device("cpu"),
                                     t_start=time.perf_counter())
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert line["attempted"] >= cell.traffic["pool"] * cell.traffic["batch"]
    assert set(line["checks"]) == set(cell.limits)
    want = ({m["name"] for m in cell.per_layer} if trace_on
            else {m["name"] for m in cell.end_to_end})
    assert set(line["metrics"]) <= want
    if trace_on:
        assert {"mfu", "crf_ms"} <= set(line["metrics"])
        assert "breakdown" in line and "window_s" in line["device"]
    else:
        assert set(line["metrics"]) == want
    assert worst["rerun_mismatch"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["pseudo_label", "serving"])
def test_a_tiny_run_on_the_card(tmp_path, card, entry):
    root = tiny.make_root(tmp_path, entry)
    cell = spec.resolve("tiny", root=root)
    line, _ = bench_run.run_cell(cell, 5, 0.2, True, card,
                                 t_start=time.perf_counter())
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert "k1_roofline" not in line["metrics"] or \
        0 < line["metrics"]["k1_roofline"]["value"] <= 105
