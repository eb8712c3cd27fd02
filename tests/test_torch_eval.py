"""Port parity for evaluation and validation: dupl_tpu_torch's
``SegEvaluator``, ``Validator`` and the two command-line tools against
dupl_tpu's, on one synthetic VOC-structured tree and the same weights
(written by the JAX package, loaded through ``state_dict_from_jax``); CPU,
float32 on both sides.

Tolerances.  Both sides compute the same fp32 function with sums in
different orders (logits agree to ~1e-4), so a pixel whose two best classes
tie may fall either way: confusion matrices may differ in 0.1% of the
pixels, mIoU by 2e-3, and the picked branch must be the same."""

import dataclasses
import logging
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu.config import CrfConfig as JCrfConfig
from dupl_tpu.config import DataConfig as JDataConfig
from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.config import voc_config as j_voc_config
from dupl_tpu.data.voc import VocSegDataset as JVocSegDataset
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.engine import eval_seg as jeval
from dupl_tpu.engine.validate import Validator as JValidator
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu_torch.config import CrfConfig, DataConfig, ModelConfig, voc_config
from dupl_tpu_torch.data.voc import VocSegDataset, write_synthetic_voc
from dupl_tpu_torch.engine import eval_seg as teval
from dupl_tpu_torch.engine.validate import Validator, cam_label_host
from dupl_tpu_torch.models.convert import load_model

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_MODEL = dict(backbone="test_tiny_patch16", compute_dtype="float32")
CROP = 64
# two shape buckets of two and three images, and a single
SIZES = [(80, 96), (96, 80), (80, 96), (64, 64), (96, 80), (80, 96)]


def _cfgs():
    kw = dict(cam_scales=(1.0, 0.5))
    return (voc_config(model=ModelConfig(**_MODEL),
                       data=DataConfig(crop_size=CROP),
                       crf=CrfConfig(iter_max=2), **kw),
            j_voc_config(model=JModelConfig(**_MODEL),
                         data=JDataConfig(crop_size=CROP),
                         crf=JCrfConfig(iter_max=2), **kw))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg, jcfg = _cfgs()
    jmodel = JDualStudent(jcfg.model)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, CROP, CROP, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    ckpt.export_weights(path, params)
    root, lists = write_synthetic_voc(str(tmp_path_factory.mktemp("voc")),
                                      SIZES, seed=1)
    model = load_model(cfg, path, "cpu")
    return dict(cfg=cfg, jcfg=jcfg, jmodel=jmodel, params=params, path=path,
                root=root, lists=lists, model=model)


def _datasets(s, transfer_dtype="float32"):
    kw = dict(transfer_dtype=transfer_dtype)
    return (VocSegDataset(s["root"], s["lists"], "val", **kw),
            JVocSegDataset(s["root"], s["lists"], "val", **kw))


def _assert_hists_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.sum() == want.sum() > 0, what
    moved = np.abs(got - want).sum() / 2
    assert moved <= 1e-3 * want.sum(), (what, moved, want.sum())


def _assert_results_close(got, want):
    assert got["branch"] == want["branch"]
    for k in ("hist_1", "hist_2", "crf_hist"):
        assert (k in got) == (k in want)
        if k in want:
            _assert_hists_close(got[k], want[k], k)
    for k in ("seg_score_1", "seg_score_2", "crf_score"):
        if k in want:
            assert abs(got[k]["miou"] - want[k]["miou"]) <= 2e-3, k


def _both(s, ev_kw, run_kw, transfer_dtype="float32"):
    tds, jds = _datasets(s, transfer_dtype)
    got = teval.SegEvaluator(s["cfg"], s["model"], **ev_kw).run(tds, **run_kw)
    want = jeval.SegEvaluator(s["jcfg"], s["jmodel"], **ev_kw).run(
        s["params"], jds, **run_kw)
    return got, want


def test_resolve_input_mode(caplog):
    for ds, req in (("voc", None), ("coco", None), ("coco", "native"),
                    ("voc", "native")):
        assert (teval.resolve_input_mode(ds, req)
                == jeval.resolve_input_mode(ds, req))
    log = logging.getLogger("port-guard-test")
    with caplog.at_level(logging.WARNING, logger="port-guard-test"):
        assert teval.resolve_input_mode("voc", "fixed", log) == "fixed"
    msgs = [r.message for r in caplog.records]
    assert any("not the reference protocol" in m for m in msgs)
    assert not any("50x" in m or "relay" in m for m in msgs)
    with pytest.raises(ValueError, match="fixed-input"):
        teval.SegEvaluator(None, None, input_mode="native", merge_at="decoder")


@pytest.mark.parametrize("transfer_dtype", ["float32", "uint8"])
def test_native_mode_two_buckets_matches_jax(setup, transfer_dtype):
    """The VOC protocol: native resolution, shape buckets (80 x 96 three
    images, 96 x 80 two, 64 x 64 one) at batch 2, scales 1.0 and 1.5, max
    merge, argmax on the device; both image wire formats."""
    got, want = _both(setup, dict(scales=(1.0, 1.5), merge="max",
                                  input_mode="native"),
                      dict(batch_size=2, crf="none"), transfer_dtype)
    _assert_results_close(got, want)
    labelled = sum(h * w - 4 for h, w in SIZES)   # 4 ignore pixels an image
    assert got["hist_1"].sum() == got["hist_2"].sum() == labelled
    assert "crf_hist" not in got and "crf_branch" not in got


def test_native_mode_buckets_by_shape(setup):
    tds, _ = _datasets(setup)
    ev = teval.SegEvaluator(setup["cfg"], setup["model"], input_mode="native")
    chunks = ev._chunks(tds, list(range(len(tds))), 2)
    assert chunks == [[0, 2], [5], [1, 4], [3]]
    assert ev._chunks(object(), [0, 1, 2], 2) == [[0], [1], [2]]
    fixed = teval.SegEvaluator(setup["cfg"], setup["model"])
    assert fixed._chunks(tds, list(range(5)), 2) == [[0, 1], [2, 3], [4]]


def test_fixed_mode_decoder_merge_matches_jax(setup):
    """The COCO protocol: fixed crop, scales merged by sum at the scale-1.0
    decoder grid, fp32 logits resized on the host in PIL; device CRF at the
    crop size."""
    got, want = _both(setup, dict(scales=(1.0, 1.25), merge="sum",
                                  input_mode="fixed", merge_at="decoder"),
                      dict(batch_size=4, crf="device"))
    _assert_results_close(got, want)
    assert got["crf_branch"] == got["branch"]


def test_native_mode_device_crf_matches_jax(setup, tmp_path):
    """Native resolution with the device CRF: logits and images edge-padded
    to multiples of 8 (none of 80 x 96 ... needs it; the 50 x 70 case below
    does), uint8 labels off the device, predictions written."""
    got, want = _both(setup, dict(scales=(1.0,), merge="max",
                                  input_mode="native"),
                      dict(batch_size=2, crf="device",
                           out_dir=str(tmp_path / "out")))
    _assert_results_close(got, want)
    assert got["crf_branch"] == got["branch"]
    preds = sorted((tmp_path / "out" / "seg_preds").iterdir())
    assert len(preds) == len(SIZES)
    assert len(list((tmp_path / "out" / "seg_preds_rgb").iterdir())) == len(SIZES)
    from PIL import Image
    first = np.asarray(Image.open(preds[0]))
    assert first.shape == SIZES[0] and first.max() <= 20


def test_native_mode_pads_to_multiples_of_8(setup, tmp_path):
    root, lists = write_synthetic_voc(str(tmp_path / "odd"),
                                      [(50, 70), (50, 70)], seed=2)
    s = dict(setup, root=root, lists=lists)
    got, want = _both(s, dict(scales=(1.0,), merge="max", input_mode="native"),
                      dict(batch_size=2, crf="device"))
    _assert_results_close(got, want)
    assert got["crf_hist"].sum() == 2 * (50 * 70 - 4)


def test_ensemble_and_forced_branch_match_jax(setup):
    kw = dict(scales=(1.0,), merge="max", input_mode="native")
    got, want = _both(setup, kw, dict(batch_size=2, crf="device",
                                      ensemble=True))
    _assert_results_close(got, want)
    assert got["crf_branch"] == 0
    other = 3 - got["branch"]
    got, want = _both(setup, kw, dict(batch_size=2, crf="device",
                                      branch=other))
    _assert_results_close(got, want)
    assert got["branch"] == got["crf_branch"] == other


def test_native_crf_matches_jax(setup):
    """``crf='native'``: the permutohedral oracle at native resolution on
    host-resized logits, through each package's own bridge to the same C++
    sources."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build native/densecrf")
    got, want = _both(setup, dict(scales=(1.0,), merge="max",
                                  input_mode="fixed"),
                      dict(batch_size=3, crf="native", max_images=3))
    _assert_results_close(got, want)


def test_two_shards_merge_to_the_whole(setup):
    """Two strided shards, merged, give the one-process confusion matrices
    exactly and the JAX package's merged result; with the CRF branch forced
    to the merged pick the CRF histograms merge too."""
    tds, jds = _datasets(setup)
    kw = dict(scales=(1.0,), merge="max", input_mode="native")
    ev = teval.SegEvaluator(setup["cfg"], setup["model"], **kw)
    full = ev.run(tds, batch_size=2, crf="none")
    shards = [ev.run(tds, batch_size=2, crf="none", shard=i, num_shards=2)
              for i in range(2)]
    merged = teval.merge_shard_results(shards)
    np.testing.assert_array_equal(merged["hist_1"], full["hist_1"])
    np.testing.assert_array_equal(merged["hist_2"], full["hist_2"])
    assert merged["branch"] == full["branch"] and "crf_hist" not in merged
    jev = jeval.SegEvaluator(setup["jcfg"], setup["jmodel"], **kw)
    jmerged = jeval.merge_shard_results(
        [jev.run(setup["params"], jds, batch_size=2, crf="none", shard=i,
                 num_shards=2) for i in range(2)])
    _assert_results_close(merged, jmerged)

    forced = [ev.run(tds, batch_size=2, crf="device", shard=i, num_shards=2,
                     branch=merged["branch"]) for i in range(2)]
    whole = ev.run(tds, batch_size=2, crf="device", branch=merged["branch"])
    both = teval.merge_shard_results(forced)
    assert both["crf_branch"] == merged["branch"]
    np.testing.assert_array_equal(both["crf_hist"], whole["crf_hist"])
    assert both["crf_score"]["miou"] == whole["crf_score"]["miou"]


def test_merge_refuses_crf_hists_of_different_branches(setup):
    """Shards that refined different branches (each picked from its own
    images, or was told differently) have no common CRF metric: the merge
    raises instead of summing them, as it does for a CRF histogram of
    unknown origin."""
    tds, _ = _datasets(setup)
    ev = teval.SegEvaluator(setup["cfg"], setup["model"], scales=(1.0,),
                            input_mode="native")
    shards = [ev.run(tds, batch_size=2, crf="device", shard=i, num_shards=2,
                     branch=i + 1) for i in range(2)]
    assert [r["crf_branch"] for r in shards] == [1, 2]
    with pytest.raises(ValueError, match="different branches"):
        teval.merge_shard_results(shards)
    mixed = [dict(shards[0], crf_branch=0), dict(shards[0])]
    with pytest.raises(ValueError, match="different branches"):
        teval.merge_shard_results(mixed)              # ensemble with branch 1
    unknown = [{k: v for k, v in shards[0].items() if k != "crf_branch"}] * 2
    with pytest.raises(ValueError, match="None unknown"):
        teval.merge_shard_results(unknown)
    same = teval.merge_shard_results([shards[0], shards[0]])
    np.testing.assert_array_equal(same["crf_hist"], 2 * shards[0]["crf_hist"])
    # a shard without a CRF pass does not stand in the way
    raw_only = {k: shards[1][k] for k in ("hist_1", "hist_2")}
    assert teval.merge_shard_results([shards[0], raw_only])["crf_branch"] == 1


def test_msc_logits_at_a_size_off_the_patch_grid_matches_jax(setup):
    """A 375 x 500 image at scale 1.5 is 562 x 750: not a multiple of 16.
    The patch conv and ``ViT.forward`` both floor to a 35 x 46 grid (1611
    tokens), the position table is bicubic-resized to it, and the decoder
    output is resized back to 375 x 500.  atol 2e-4 on logits of magnitude
    ~1 (fp32 summation order through two resizes)."""
    x = np.random.RandomState(0).randn(1, 375, 500, 3).astype(np.float32)
    jm, params = setup["jmodel"], setup["params"]
    want = np.asarray(jeval.msc_seg_logits(
        lambda both: jm.apply(params, both).seg, jnp.asarray(x), (375, 500),
        (1.5,), "max", batch_dims=2))
    with torch.no_grad():
        fmap = setup["model"](torch.from_numpy(np.zeros(
            (1, 562, 750, 3), np.float32))).fmap
        got = teval.msc_seg_logits(lambda both: setup["model"](both).seg,
                                   torch.from_numpy(x), (375, 500), (1.5,),
                                   "max", batch_dims=2)
    assert fmap.shape == (2, 1, 35, 46, 32)
    assert got.shape == want.shape == (2, 1, 375, 500, 21)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("device_post", [True, False])
def test_validator_matches_jax(setup, device_post):
    """Both post paths: on the device (bilinear resize, threshold, argmax,
    uint8 labels) and on the host (PIL).  Five images at batch 2: the last
    chunk is padded by repetition.  mIoUs within 2e-3, the F1 of the
    classification logits equal."""
    tds, jds = _datasets(setup)
    got = Validator(setup["cfg"], setup["model"],
                    device_post=device_post).run(tds, max_images=5,
                                                 batch_size=2)
    want = JValidator(setup["jcfg"], setup["jmodel"],
                      device_post=device_post).run(setup["params"], jds,
                                                   max_images=5, batch_size=2)
    keys = ("cam_1", "cam_aux_1", "seg_1", "cam_2", "cam_aux_2", "seg_2")
    for k in keys:
        assert abs(got[f"{k}_miou"] - want[f"{k}_miou"]) <= 2e-3, k
        assert np.isfinite(got[f"{k}_miou"])
    assert got["cls_f1_1"] == want["cls_f1_1"]
    assert got["cls_f1_2"] == want["cls_f1_2"]
    assert got["table"].splitlines()[0] == want["table"].splitlines()[0]
    assert set(got["scores"]) == set(keys)


def test_validator_transfer_dtype(setup):
    """bf16 rounds the CAMs only on the host path, where the scores follow
    the JAX package's bf16 scores (within 2e-3); under ``device_post`` the
    cast is skipped and the scores are exactly the fp32 ones."""
    tds, jds = _datasets(setup)
    run = lambda **kw: Validator(setup["cfg"], setup["model"], **kw).run(
        tds, max_images=3, batch_size=2)
    a, b = run(), run(transfer_dtype="bfloat16")
    c = run(device_post=False)
    d = run(device_post=False, transfer_dtype="bfloat16")
    want = JValidator(setup["jcfg"], setup["jmodel"], device_post=False,
                      transfer_dtype="bfloat16").run(
        setup["params"], jds, max_images=3, batch_size=2)
    for k in ("cam_1_miou", "cam_aux_2_miou", "seg_1_miou"):
        assert a[k] == b[k]
        assert abs(d[k] - want[k]) <= 2e-3
    assert c["seg_1_miou"] == d["seg_1_miou"]      # only the CAMs are cast
    assert any(c[k] != d[k] for k in ("cam_1_miou", "cam_2_miou",
                                      "cam_aux_1_miou", "cam_aux_2_miou"))


def test_cam_label_host_matches_jax():
    from dupl_tpu.engine.validate import cam_label_host as j_cam_label_host
    rs = np.random.RandomState(0)
    cam = (rs.rand(12, 9, 20) * rs.rand(12, 9, 1)).astype(np.float32)
    cl = (rs.rand(20) > 0.6).astype(np.float32)
    got = cam_label_host(cam, cl, 0.45)
    np.testing.assert_array_equal(got, j_cam_label_host(cam, cl, 0.45))
    assert got.min() == 0 and set(np.unique(got)) - {0} <= set(
        np.flatnonzero(cl) + 1)


def _tool(script, *args):
    return subprocess.run([sys.executable, str(ROOT / "tools" / script), *args],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)


def test_eval_cli_on_the_cpu(setup, tmp_path):
    """``tools/eval_seg_torch.py --device cpu`` on the tiny tree: two shards
    with a forced branch saved with ``--save-hists`` (histograms and the
    CRF's branch), then ``--merge-hists``; a shard that refined the other
    branch makes the merge fail."""
    common = ["--weights", setup["path"], "--data-folder", setup["root"],
              "--list-folder", setup["lists"], "--backbone",
              "test_tiny_patch16", "--crop-size", str(CROP), "--device", "cpu",
              "--scales", "1.0", "--batch-size", "2", "--num-shards", "2"]
    files = []
    for shard, branch in ((0, 1), (1, 1), (1, 2)):
        files.append(str(tmp_path / f"h{shard}{branch}.npz"))
        r = _tool("eval_seg_torch.py", *common, "--shard", str(shard),
                  "--branch", str(branch), "--save-hists", files[-1])
        assert r.returncode == 0, r.stderr[-2000:]
        assert "mIoU" in r.stdout and f"branch{branch}+CRF" in r.stdout
        saved = np.load(files[-1])
        assert int(saved["crf_branch"]) == branch
        assert saved["hist_1"].sum() == saved["crf_hist"].sum() > 0
    r = _tool("eval_seg_torch.py", "--merge-hists", files[0], files[1])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "merged 2 shards" in r.stdout and "merged+CRF" in r.stdout
    r = _tool("eval_seg_torch.py", "--merge-hists", files[0], files[2])
    assert r.returncode != 0 and "different branches" in r.stderr


@pytest.mark.parametrize("args,message", [
    ((), "no CUDA device"),
    (("--device", "cpu", "--no-data"),
     "either --data-folder or --records is required"),
    (("--device", "cpu", "--no-weights"), "--weights is required")])
def test_eval_cli_refusals(setup, args, message):
    """Without a card the tool refuses to start unless told ``--device
    cpu``; as the JAX tool, it needs ``--weights`` and a directory tree or
    ``--records`` (``--no-data`` / ``--no-weights`` stand for leaving the
    flag out)."""
    given = [("--weights", setup["path"]), ("--data-folder", setup["root"])]
    drop = {"--no-data": "--data-folder", "--no-weights": "--weights"}
    argv = [x for flag, value in given if flag not in
            {drop.get(a) for a in args} for x in (flag, value)]
    r = _tool("eval_seg_torch.py", *argv, "--list-folder", setup["lists"],
              *[a for a in args if a not in drop])
    assert r.returncode != 0 and message in r.stderr


def test_infer_cam_cli_on_the_cpu(setup, tmp_path):
    out = tmp_path / "cams"
    r = _tool("infer_cam_torch.py", "--weights", setup["path"],
              "--data-folder", setup["root"], "--list-folder", setup["lists"],
              "--backbone", "test_tiny_patch16", "--crop-size", str(CROP),
              "--device", "cpu", "--max-images", "2", "--branch", "2",
              "--out-dir", str(out))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "CAM-label mIoU:" in r.stdout
    from PIL import Image
    jpgs = sorted(out.iterdir())
    assert len(jpgs) == 2
    assert Image.open(jpgs[0]).size == (SIZES[0][1], SIZES[0][0])


def test_jet_matches_matplotlib():
    """The port's own jet colormap against ``matplotlib.cm.jet`` where that
    imports (the overlay's uint8 values equal)."""
    cm = pytest.importorskip("matplotlib.cm")
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import infer_cam_torch
    finally:
        sys.path.pop(0)
    x = np.concatenate([np.linspace(0, 1, 1001),
                        np.random.RandomState(0).rand(500), [-0.5, 1.5]])
    want = cm.jet(np.clip(x, 0, 1))[..., :3]
    np.testing.assert_allclose(infer_cam_torch.jet(np.clip(x, 0, 1)), want,
                               rtol=0, atol=1e-12)
    img = np.random.RandomState(1).randint(0, 256, (1503, 1, 3)).astype(np.uint8)
    heat = (want * 255).astype(np.float32)[:, None]
    np.testing.assert_array_equal(
        infer_cam_torch.jet_overlay(img, x[:, None]),
        (0.5 * heat + 0.5 * img.astype(np.float32)).astype(np.uint8))
