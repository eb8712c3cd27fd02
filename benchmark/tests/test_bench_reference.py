"""The plain reference against ``dupl_tpu_torch``'s two entries on the CPU,
at a tiny size (``test_tiny_patch16``, crop 64), on the benchmark's own
inputs and weights.

With the port in float32 (compute, residual stream and PAR) and its fast
CRF's two bf16 roundings taken out, the two compute the same mathematics
and agree to float32 rounding; the int8 path agrees with the reference's
w8a8 products (a quantization step may flip where float32 sums differ in
their last bit).  The reference imports nothing of ``dupl_tpu_torch``, the
JAX package or JAX, checked in a fresh interpreter.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import compare, nojax, traffic, weights  # noqa: E402
from benchmark.reference import dual_student as ref  # noqa: E402
from benchmark.tests import tiny  # noqa: E402


@contextlib.contextmanager
def crf_in_fp32():
    """The port's fast CRF with its kernel entries and pivot products in
    float32 (no bf16 rounding): the mathematics the reference computes."""
    from dupl_tpu_torch.ops import crf, crf_cuda

    def apply(basis, coef, logc, vals, block_rows=25088):
        k = torch.exp(torch.minimum(torch.matmul(basis, coef),
                                    logc[:, None, :]))
        return torch.matmul(k, vals)

    orig = crf_cuda.kernel_apply, crf._bf16_matmul
    crf_cuda.kernel_apply = apply
    crf._bf16_matmul = lambda a, x: torch.matmul(a.float(), x)
    try:
        yield
    finally:
        crf_cuda.kernel_apply, crf._bf16_matmul = orig


def _port(config: dict, fp32: bool):
    from benchmark import program

    cfg = program.port_config(config)
    if fp32:
        m = dataclasses.replace(cfg.model, compute_dtype="float32",
                                stream_dtype="float32")
        cfg = dataclasses.replace(cfg, model=m, par=dataclasses.replace(
            cfg.par, compute_dtype="float32"))
    w = weights.make(config, 5, "cpu")
    return cfg, program.build_model(cfg, w, torch.device("cpu")), w


def _entry(name: str, cfg, model, config, traffic_):
    from benchmark import spec

    mod = spec.load_module(ROOT / "benchmark" / "entries" / f"{name}.py")
    return mod.Entry(cfg, model, config, traffic_, torch.device("cpu"))


@pytest.mark.parametrize("entry", ["pseudo_label", "serving"])
def test_reference_matches_port_fp32(entry):
    config = tiny.config()
    t = tiny.traffic(entry)
    cfg, model, w = _port(config, fp32=True)
    e = _entry(entry, cfg, model, config, t)
    batch = traffic.generate(t, 11)[0]
    js = list(range(t["batch"]))
    with crf_in_fp32(), torch.no_grad():
        capt = e.capture(e.inputs(batch), 1)
        out = e.reference(ref, w, batch, js, e.stage_inputs(capt, js))
    keys = (("cams", "par", "crf", "crf_step") if entry == "pseudo_label"
            else ("seg",))
    for k in keys:
        for j in js:
            mine = k.replace("_step", "")
            got = capt[mine][:, j] if k in ("cams", "seg") else capt[mine][j]
            want = out[k][:, j] if k in ("cams", "seg") else out[k][j]
            assert compare.rel_err(got, want) < 2e-5, (k, j)
    for name, gelu, x, y in capt["products"]:
        want = ref.product(w, name, x, gelu, config, "fp32")
        assert compare.rel_err(y, want) < 2e-6, name
    assert len(capt["products"]) == 2 * config["depth"] * 4 * (
        3 if entry == "pseudo_label" else len(t["scales"]))
    labels = capt["out"]
    if entry == "pseudo_label":
        assert compare.mismatch(labels[0], out["refined"]) < 2e-3
        assert compare.mismatch(labels[1], out["crf_labels"]) < 2e-3
    else:
        with torch.no_grad():
            full = ref.serving(w, config, torch.from_numpy(batch["images"]),
                               t["scales"], t["merge"])
        with crf_in_fp32(), torch.no_grad():
            served = e(e.inputs(batch))
        assert compare.mismatch(served[0], full["labels"]) < 2e-3


def test_reference_int8_matches_port():
    config = dict(tiny.config(), quantized_inference=True)
    t = tiny.traffic("pseudo_label")
    cfg, model, w = _port(config, fp32=True)
    e = _entry("pseudo_label", cfg, model, config, t)
    batch = traffic.generate(t, 3)[0]
    js = list(range(t["batch"]))
    with crf_in_fp32(), torch.no_grad():
        capt = e.capture(e.inputs(batch), 2)
        out8 = e.reference(ref, w, batch, js, None)
        out4 = e.reference(ref, w, batch, js, None, prec="int4")
        plain = e.reference(ref, w, batch, js, None, prec="fp32")
        fp8 = e.reference(ref, w, batch, js, None, prec="fp8")
    for name, gelu, x, y in capt["products"]:
        assert compare.rel_err(y, ref.product(w, name, x, gelu, config)) < 1e-3
    for j in js:
        err8 = compare.rel_err(capt["cams"][:, j], out8["cams"][:, j])
        assert err8 < 5e-3
        # the int8 reference is not the float one, and int4 is farther
        far8 = compare.rel_err(out8["cams"][:, j], plain["cams"][:, j])
        far4 = compare.rel_err(out4["cams"][:, j], plain["cams"][:, j])
        assert err8 < far8 < far4
        assert compare.rel_err(fp8["cams"][:, j], plain["cams"][:, j]) > far8


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.dual_student; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert "dupl_tpu_torch" not in out
    assert nojax.found(out) == []
    assert "torch" in out
