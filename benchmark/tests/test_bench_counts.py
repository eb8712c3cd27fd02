"""The analytic counts of ``benchmark/counts.py``: the model FLOPs of both
entries equal ``FlopCounterMode`` over the plain reference (which computes
what the outputs need and nothing else), and the kernel bounds give the
least times ``PERF.md``'s kernel table was set from."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import counts, traffic, weights  # noqa: E402
from benchmark.reference import dual_student as ref  # noqa: E402
from benchmark.tests import tiny  # noqa: E402


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as c, torch.no_grad():
        fn()
    return c.get_total_flops()


@pytest.mark.parametrize("quantized", [False, True])
def test_pseudo_label_flops_match_the_counter(quantized):
    config = tiny.config(quantized)
    t = tiny.traffic("pseudo_label")
    b = traffic.generate(t, 1)[0]
    w = weights.make(config, 1, "cpu")
    want = counts.pseudo_label_flops(config, t["batch"], t["crop"], t["crop"])
    got = _counted(lambda: ref.pseudo_label(
        w, config, torch.from_numpy(b["images"]),
        torch.from_numpy(b["cls_label"]), torch.from_numpy(b["img_box"]),
        True))
    assert got == sum(want.values())
    assert ("int8" in want) == quantized


def test_serving_flops_match_the_counter():
    config = tiny.config()
    t = tiny.traffic("serving")
    b = traffic.generate(t, 2)[0]
    w = weights.make(config, 2, "cpu")
    want = counts.serving_flops(config, t["batch"], t["crop"], t["crop"],
                                t["scales"])
    got = _counted(lambda: ref.serving(w, config,
                                       torch.from_numpy(b["images"]),
                                       t["scales"], t["merge"]))
    assert got == sum(want.values())


def test_kernel_bounds_are_the_kernel_tables():
    ms = 1e3
    # PERF.md's kernel table: K1 at BH 192 (16 x 12 heads) and N 1765,
    # K5 at B 2, N 200,704, Ns 3,136, V 22, K4 at 16 x 224^2, C 40, and
    # Q2's fc1 (M 12,560, N 3072, K 768)
    assert counts.k1_bound(16, 1765, 12, 64) * ms == pytest.approx(0.155,
                                                                   abs=5e-4)
    assert counts.k5_bound(2, 200704, 3136, 22) * ms == pytest.approx(
        0.413, abs=5e-4)
    assert counts.k4_bound(16, 40, 224, 224, 48, 10, 4) * ms == \
        pytest.approx(0.460, abs=5e-4)
    assert counts.k4_bound(16, 40, 224, 224, 48, 10, 2) * ms == \
        pytest.approx(0.230, abs=5e-4)
    assert counts.q2_bound(12560, 3072, 768) * ms == pytest.approx(
        0.0497, abs=5e-5)


def test_least_time_of_the_headline_call():
    """The bf16 label call: about 2.4 TFLOP an image of bf16 products."""
    import json

    with open(ROOT / "benchmark" / "configs" / "dupl-vitb16-voc.json") as f:
        config = json.load(f)
    f = counts.pseudo_label_flops(config, 16, 448, 448)
    assert 2.2e12 < f["bf16"] / 16 < 2.6e12
    assert 0.03 < counts.least_seconds(f) < 0.06
