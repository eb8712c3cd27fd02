"""TensorBoard output of the port (dupl_tpu_torch/utils/tb.py and its calls
in tools/train_torch.py) against the JAX package's (dupl_tpu/utils/tb.py,
tools/train.py:286-311, 376-390, 423-425): the grids bit for bit on the
same arrays, the writer read back by tensorboard's own event reader and a
no-op without a backend, the CAM-grid pass against the JAX one on carried
weights, and the training tool's tags and steps."""

import dataclasses
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dupl_tpu import config as jconfig
from dupl_tpu.engine import checkpoint as jckpt
from dupl_tpu.engine.train import Trainer as JTrainer
from dupl_tpu.ops import image as jimage
from dupl_tpu.utils import tb as jtb
from dupl_tpu_torch import config as tconfig
from dupl_tpu_torch.data import voc as tvoc
from dupl_tpu_torch.engine.train import Trainer
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.utils import tb

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _events(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0,
                                                        "images": 0})
    acc.Reload()
    return acc


@pytest.mark.parametrize("b,nrow", [(4, 2), (3, 2), (5, 3)])
def test_image_grid_equals_jax(b, nrow):
    """Bit for bit, including values outside [0, 1] (clipped) and short
    last rows (zeros)."""
    x = np.random.RandomState(b).uniform(-0.2, 1.2, (b, 12, 10, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(tb.image_grid(x, nrow),
                                  jtb.image_grid(x, nrow))


@pytest.mark.parametrize("cam_hw", [(24, 20), (12, 10), (7, 9)],
                         ids=["full", "half", "ragged"])
def test_cam_overlay_grid_equals_jax(cam_hw):
    """The JAX grid colours with matplotlib's jet, the port with its own
    table (``utils/colormap.jet``, no plotting library) on the same float32
    arrays: at the image's resolution, at half of it, and at a size that
    divides neither side (the nearest upsample's index arithmetic).  Every
    uint8 level equal: the two tables differ by at most 4.4e-16 in a few
    entries (np.interp against matplotlib's own interpolation), far below
    the float32 rounding of the blend; the equality is asserted, not
    assumed.  CAM values outside [0, 1] and exact 0 and 1 included."""
    rs = np.random.RandomState(sum(cam_hw))
    imgs = rs.rand(3, 24, 20, 3).astype(np.float32)
    cams = rs.uniform(-0.1, 1.1, (3, *cam_hw, 4)).astype(np.float32)
    cams[0, 0, 0] = 1.0
    cams[1, 0, 0] = 0.0
    np.testing.assert_array_equal(tb.cam_overlay_grid(imgs, cams),
                                  jtb.cam_overlay_grid(imgs, cams))


def test_writer_round_trip_and_no_op(tmp_path, monkeypatch):
    """Scalars and HWC images come back through tensorboard's event reader
    (scalars as float32, images as the same uint8 pixels); ``None`` and a
    machine with neither backend give a writer that writes nothing."""
    w = tb.TbWriter(str(tmp_path / "tb"))
    assert w.enabled
    img = np.random.RandomState(0).randint(0, 256, (6, 8, 3)).astype(np.uint8)
    w.scalar("Loss/total", 1.25, 3)
    w.scalar("Loss/total", np.float32(0.5), 5)
    w.image("CAM/inputs", img, 5)
    w.close()
    w.close()                          # a second close is harmless
    acc = _events(tmp_path / "tb")
    assert [(e.step, e.value) for e in acc.Scalars("Loss/total")] == [
        (3, 1.25), (5, 0.5)]
    (ev,) = acc.Images("CAM/inputs")
    assert (ev.step, ev.height, ev.width) == (5, 6, 8)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(ev.encoded_image_string))), img)

    off = tb.TbWriter(None)
    assert not off.enabled
    off.scalar("x", 1.0, 1)
    off.image("y", img, 1)
    off.close()
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    none = tb.TbWriter(str(tmp_path / "none"))
    assert not none.enabled
    none.scalar("x", 1.0, 1)
    none.close()
    assert not (tmp_path / "none").exists()


def _cfg(mod):
    base = mod.voc_config()
    return mod.voc_config(
        model=dataclasses.replace(base.model, backbone="test_tiny_patch16",
                                  compute_dtype="float32"),
        data=dataclasses.replace(base.data, crop_size=64),
        cam_merge_downscale=2)


def test_cam_grids_match_jax(tmp_path):
    """``cam_grids`` against the JAX tool's grid pass
    (``prepare_inputs`` -> ``Trainer._multi_scale_cams(...)[0]`` -> masked
    by the labels -> ``image_grid`` / ``cam_overlay_grid``) on a uint8 batch
    of 5 (4 taken), the same JAX-initialised weights, fp32, exact softmax on
    both sides, CAMs merged at half the input size.  The inputs grid is bit
    for bit (the same uint8 / 255); the CAMs agree within 1e-4 (min-max
    normalised to [0, 1]; fp32 summation order); so an overlay level can
    differ only where a CAM value sits on an edge of jet's 256-entry table,
    and then by at most one table step (4/255 a channel) halved by the blend:
    at most 3 levels after truncation, on at most 1% of the pixels."""
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    jtrainer = JTrainer(jcfg)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 3), jnp.float32))
    jckpt.export_weights(str(tmp_path / "w.npz"), jstate.params)
    model = DualStudent(tcfg.model)
    model.load_state_dict(load_weights(str(tmp_path / "w.npz")))
    trainer = Trainer(tcfg, model=model, device="cpu")
    trainer.init_state(init=False)

    rs = np.random.RandomState(7)
    u8 = rs.randint(0, 256, (5, 64, 64, 3)).astype(np.uint8)
    u8[:, 16:40, 8:30] = rs.randint(0, 256, (5, 1, 1, 3))      # a flat blob
    cls_label = (rs.rand(5, 20) > 0.8).astype(np.float32)
    cls_label[:, 3] = 1

    norm, images01 = jimage.prepare_inputs(jnp.asarray(u8[:4]))
    jcams = np.asarray(jtrainer._multi_scale_cams(jstate.params, norm)[0],
                       np.float32) * cls_label[None, :4, None, None, :]
    images01 = np.asarray(images01, np.float32)
    want = {"CAM/inputs": jtb.image_grid(images01),
            "CAM/cams_1": jtb.cam_overlay_grid(images01, jcams[0]),
            "CAM/cams_2": jtb.cam_overlay_grid(images01, jcams[1])}

    seen = []
    inner = trainer._multi_scale_cams
    trainer._multi_scale_cams = lambda x: seen.append(inner(x)) or seen[-1]
    got = tb.cam_grids(trainer, torch.from_numpy(u8), torch.from_numpy(
        cls_label))
    cams = seen[0][0].numpy() * cls_label[None, :4, None, None, :]
    assert cams.shape == jcams.shape == (2, 4, 32, 32, 20)
    np.testing.assert_allclose(cams, jcams, rtol=0, atol=1e-4)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["CAM/inputs"], want["CAM/inputs"])
    for k in ("CAM/cams_1", "CAM/cams_2"):
        assert got[k].shape == want[k].shape == (128, 128, 3)
        diff = np.abs(got[k].astype(np.int32) - want[k].astype(np.int32))
        print(f"{k}: CAM max abs err {np.abs(cams - jcams).max():.3g}, "
              f"pixels off {(diff.max(-1) > 0).mean():.5f}, most "
              f"{diff.max()} levels")
        assert diff.max() <= 3, k
        assert (diff.max(-1) > 0).mean() <= 0.01, k


def _tool():
    spec = importlib.util.spec_from_file_location(
        "_train_torch_tb", ROOT / "tools" / "train_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_training_tool_writes_the_jax_tags(tmp_path):
    """``tools/train_torch.py --device cpu``, 4 steps through warm-up, seg
    and full, a log every 2 steps and validation at 4: the event file holds
    exactly the JAX tool's tags at its steps (the scalars and CAM grids at
    each log boundary, the validation mIoUs at each validation), and each
    scalar equals the run's own ``metrics.jsonl`` record up to that file's
    rounding (6 decimals; 4 for cls_f1 and s_per_iter) and TensorBoard's
    float32."""
    root, lists = tvoc.write_synthetic_voc(
        str(tmp_path / "voc"), [(60, 80)] * 2, seed=3,
        train_sizes=[(70, 90), (64, 64), (90, 70), (80, 80)])
    work = tmp_path / "work"
    assert _tool().main([
        "--device", "cpu", "--data-folder", root, "--list-folder", lists,
        "--work-dir", str(work), "--backbone", "test_tiny_patch16",
        "--crop-size", "64", "--cam-iters", "1", "--gmm-iters", "2",
        "--max-iters", "4", "--log-iters", "2", "--eval-iters", "4",
        "--samples-per-device", "2", "--num-workers", "2"]) == 0
    (run_dir,) = work.iterdir()
    acc = _events(run_dir / "tb")
    losses = ("cls_loss", "ptc_loss", "seg_loss", "sim_loss", "reg_loss")
    train_tags = ([f"Loss/{k}" for k in losses]
                  + ["Loss/total", "train/cls_f1", "lr", "perf/s_per_iter"])
    val_tags = [f"val/{k}_miou" for k in ("cam_1", "cam_2", "cam_aux_1",
                                          "cam_aux_2", "seg_1", "seg_2")]
    tags = acc.Tags()
    assert sorted(tags["scalars"]) == sorted(train_tags + val_tags)
    assert sorted(tags["images"]) == ["CAM/cams_1", "CAM/cams_2",
                                      "CAM/inputs"]
    for t in tags["images"]:
        assert [(e.step, e.height, e.width) for e in acc.Images(t)] == [
            (2, 64, 128), (4, 64, 128)]
    recs = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
    train = {r["step"]: r for r in recs if r["event"] == "train"}
    val = {r["step"]: r for r in recs if r["event"] == "val"}
    assert sorted(train) == [2, 4] and sorted(val) == [4]
    fields = {**{f"Loss/{k}": (k, 6) for k in losses},
              "Loss/total": ("loss", 6), "train/cls_f1": ("cls_f1", 4),
              "lr": ("lr", None), "perf/s_per_iter": ("s_per_iter", 4),
              **{t: (t[4:], 4) for t in val_tags}}
    for t in train_tags + val_tags:
        events = acc.Scalars(t)
        steps = sorted(val if t.startswith("val/") else train)
        assert [e.step for e in events] == steps, t
        key, digits = fields[t]
        for e in events:
            want = (val if t.startswith("val/") else train)[e.step][key]
            bound = (0 if digits is None else 0.5 * 10.0 ** -digits) \
                + abs(want) * 2.0 ** -23
            assert abs(e.value - want) <= bound, (t, e.step, e.value, want)
