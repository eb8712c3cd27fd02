"""The port's smaller run operations against the JAX package's: the ASPP
decoder through the weight bridge, the VOC-palette PNG writer and
tools/convert_test_seg_torch.py, and the one-command repro scripts'
``--dry-run`` on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dupl_tpu.models.decoder import ASPP as JASPP
from dupl_tpu.utils import colormap as jcolormap
from dupl_tpu_torch.models import convert
from dupl_tpu_torch.models.decoder import ASPP
from dupl_tpu_torch.utils import colormap

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("rates", [(6, 12, 18, 24), (1, 3)])
def test_aspp_matches_jax_through_the_bridge(rates):
    """The JAX ``ASPP``'s params (biases made non-zero) go into the port by
    ``convert.state_dict_from_jax`` as a student's decoder leaves and come
    back by ``state_dict_to_jax`` bit for bit; in fp32 the outputs agree
    within 1e-5 of their scale (fp32 summation order), on a map smaller
    than the largest rate (taps in the padding) and one larger."""
    rs = np.random.RandomState(len(rates))
    jm = JASPP(out_planes=5, atrous_rates=rates, dtype=jnp.float32)
    x0 = jnp.zeros((1, 20, 20, 8), jnp.float32)
    params = jm.init(jax.random.PRNGKey(len(rates)), x0)
    params = jax.tree.map(
        lambda a: a + 0.1 * rs.randn(*a.shape).astype(np.float32), params)
    flat = {f"params/decoder/{conv}/{leaf}": np.stack([np.asarray(v)] * 2)
            for conv, d in params["params"].items() for leaf, v in d.items()}
    sd = convert.state_dict_from_jax(flat)
    model = ASPP(8, 5, rates, compute_dtype=torch.float32)
    model.load_state_dict({k[len("branch1.decoder."):]: v
                           for k, v in sd.items() if k.startswith("branch1.")})
    back = convert.state_dict_to_jax(
        {f"branch{i}.decoder.{k}": v for i in (1, 2)
         for k, v in model.state_dict().items()})
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    for size in (11, 30):
        x = rs.randn(2, size, size + 3, 8).astype(np.float32)
        want = np.asarray(jm.apply(params, jnp.asarray(x)))
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def _png(path):
    with Image.open(path) as img:
        return img.mode, np.asarray(img), img.getpalette()


def test_save_indexed_png_equals_jax(tmp_path):
    """Mode P, the same class indices and the same VOC palette as the JAX
    writer (every one of the 256 entries), for a map using 0-20 and 255
    (ignore)."""
    label = np.random.RandomState(0).randint(0, 21, (33, 47)).astype(np.uint8)
    label[:4, :4] = 255
    colormap.save_indexed_png(str(tmp_path / "port.png"), label)
    jcolormap.save_indexed_png(str(tmp_path / "jax.png"), label)
    got, want = _png(tmp_path / "port.png"), _png(tmp_path / "jax.png")
    assert got[0] == want[0] == "P"
    np.testing.assert_array_equal(got[1], label)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[2][:3 * 256] == colormap.voc_colormap().reshape(-1).tolist()


def test_convert_test_seg_torch_equals_the_jax_tool(tmp_path):
    """Both tools on one directory of grayscale class-index PNGs (and a file
    they must skip): the same names out, and per file the same mode, pixels
    and palette."""
    src = tmp_path / "preds"
    src.mkdir()
    rs = np.random.RandomState(1)
    for name in ("2007_000001", "2007_000002", "2008_000003"):
        Image.fromarray(rs.randint(0, 21, (29, 41)).astype(np.uint8)).save(
            src / f"{name}.png")
    (src / "notes.txt").write_text("skipped")
    outs = {}
    for tool in ("convert_test_seg_torch.py", "convert_test_seg.py"):
        out = tmp_path / tool
        r = subprocess.run(
            [sys.executable, str(ROOT / "tools" / tool), "--dir", str(src),
             "--target-dir", str(out)], capture_output=True, text=True,
            timeout=300, cwd=tmp_path)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "converted 3 masks" in r.stdout
        outs[tool] = out
    names = sorted(os.listdir(outs["convert_test_seg.py"]))
    assert sorted(os.listdir(outs["convert_test_seg_torch.py"])) == names
    for n in names:
        got = _png(outs["convert_test_seg_torch.py"] / n)
        want = _png(outs["convert_test_seg.py"] / n)
        assert got[0] == want[0] == "P"
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[1], np.asarray(Image.open(src / n)))
        assert got[2] == want[2]


def _dry_run(script, tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    r = subprocess.run(["bash", str(ROOT / "tools" / script), "--dry-run"],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=ROOT)
    sys.stdout.write(r.stdout[-2000:])
    sys.stderr.write(r.stderr[-2000:])
    assert r.returncode == 0
    return r.stdout


def test_repro_voc_torch_dry_run(tmp_path):
    """Every stage through the _torch tools on the CPU: a synthetic tree,
    6 training steps through warm-up, seg and full with validation and the
    weight export at 6, the multi-scale evaluation with the device CRF
    writing its class-index PNGs, CAM inference, the palette conversion."""
    out = _dry_run("repro_voc_torch.sh", tmp_path)
    work = tmp_path / "repro_voc_torch_dry"
    (weights,) = work.glob("run/*/checkpoints/weights.npz")
    log = weights.parents[1].joinpath("train.log").read_text()
    for phase in ("phase: warmup;", "phase: seg;", "phase: full;"):
        assert phase in log, phase
    preds = sorted(os.listdir(work / "eval" / "seg_preds"))
    assert len(preds) == 4
    assert sorted(os.listdir(work / "seg_preds_palette")) == preds
    assert len(list((work / "cams").glob("*.jpg"))) == 4
    assert "converted 4 masks" in out and "CAM-label mIoU" in out


@pytest.mark.slow
def test_repro_coco_torch_dry_run(tmp_path):
    """All four COCO phases (warm-up, seg_static, seg, full; the refine
    switch at 4), the sharded fixed-crop evaluation with the device CRF on
    3 images (one grayscale), the palette conversion."""
    out = _dry_run("repro_coco_torch.sh", tmp_path)
    work = tmp_path / "repro_coco_torch_dry"
    (weights,) = work.glob("run/*/checkpoints/weights.npz")
    log = weights.parents[1].joinpath("train.log").read_text()
    for phase in ("phase: warmup;", "phase: seg_static;", "phase: seg;",
                  "phase: full;"):
        assert phase in log, phase
    assert len(os.listdir(work / "seg_preds_palette")) == 3
    assert "converted 3 masks" in out
