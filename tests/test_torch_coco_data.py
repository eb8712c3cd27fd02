"""Port parity for the COCO datasets: ``dupl_tpu_torch.data.coco`` against
``dupl_tpu.data.coco`` on the same tree, byte for byte for the same
``(idx, seed)``; the tree written by the port's ``write_synthetic_coco`` and
the one written by ``tools/make_fake_coco.py``."""

import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from dupl_tpu.data import coco as jcoco
from dupl_tpu_torch.data import coco as tcoco

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TRAIN = [(70, 90), (64, 64), (90, 70), (80, 100), (66, 99)]
VAL = [(60, 80), (75, 75), (64, 96)]


@pytest.fixture(scope="module", params=["port", "jax_tool"])
def tree(request, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("coco"))
    if request.param == "port":
        root, lists = tcoco.write_synthetic_coco(out, VAL, TRAIN, seed=3)
    else:
        sys.path.insert(0, str(ROOT))
        try:
            from tools.make_fake_coco import make_tree
        finally:
            sys.path.pop(0)
        root = make_tree(out, n_train=5, n_val=3, size=72, num_fg=80)
        lists = os.path.join(out, "lists")
    return out, root, lists


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k], k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_layout_of_the_synthetic_tree(tree):
    out, root, lists = tree
    assert root == os.path.join(out, "coco2014")
    assert sorted(os.listdir(root)) == ["train2014", "val2014"]
    assert sorted(os.listdir(os.path.join(out, "SegmentationClass"))) == [
        "train2014", "val2014"]
    assert sorted(os.listdir(lists)) == ["cls_labels_onehot.npy", "train.txt",
                                         "val.txt", "val_part.txt"]
    val = open(os.path.join(lists, "val_part.txt")).read().split()
    assert val == open(os.path.join(lists, "val.txt")).read().split()
    first = Image.open(os.path.join(root, "val2014", val[0] + ".jpg"))
    assert first.mode == "L"                      # the grayscale image
    assert tcoco.default_label_folder(root) == jcoco.default_label_folder(root)
    for n in val + ["COCO_train2014_000000000001"]:
        assert tcoco._subdir(n) == jcoco._subdir(n)


@pytest.mark.parametrize("transfer_dtype", ["float32", "uint8"])
def test_cls_dataset_matches_jax(tree, transfer_dtype):
    _, root, lists = tree
    kw = dict(crop_size=64, transfer_dtype=transfer_dtype)
    t = tcoco.CocoClsDataset(root, lists, "train", **kw)
    j = jcoco.CocoClsDataset(root, lists, "train", **kw)
    assert t.name_list == j.name_list and len(t) == len(j) == 5
    for i in range(len(t)):
        _equal(t.__getitem__(i, seed=11 + i), j.__getitem__(i, seed=11 + i))
        assert t.image_size(i) == j.image_size(i)
    plain = dict(crop_size=64, aug=False)
    _equal(tcoco.CocoClsDataset(root, lists, "train", **plain).__getitem__(1),
           jcoco.CocoClsDataset(root, lists, "train", **plain).__getitem__(1))


@pytest.mark.parametrize("transfer_dtype", ["float32", "uint8"])
def test_seg_dataset_and_grayscale_match_jax(tree, transfer_dtype):
    _, root, lists = tree
    for split in ("val_part", "val"):
        kw = dict(transfer_dtype=transfer_dtype)
        t = tcoco.CocoSegDataset(root, lists, split, **kw)
        j = jcoco.CocoSegDataset(root, lists, split, **kw)
        for i in range(len(t)):
            _equal(t[i], j[i])
            assert t.image_size(i) == j.image_size(i) == t[i]["label"].shape
    # stage "test" takes the red plane for a mask, whose values pass 80
    # classes on these scenes: both packages raise alike
    for mod in (tcoco, jcoco):
        with pytest.raises(IndexError):
            mod.CocoSegDataset(root, lists, stage="test")[1]
    gray = tcoco.CocoSegDataset(root, lists)[0]["raw_image"]
    assert gray.shape[2] == 3
    np.testing.assert_array_equal(gray[..., 0], gray[..., 2])


def test_labels_from_masks_without_the_table(tree, tmp_path):
    """``cls_labels_onehot.npy`` deleted: both packages derive the one-hot
    from the mask, and it equals the table's."""
    _, root, lists = tree
    bare = str(tmp_path / "lists")
    shutil.copytree(lists, bare)
    os.remove(os.path.join(bare, "cls_labels_onehot.npy"))
    t = tcoco.CocoClsDataset(root, bare, "train", crop_size=64)
    j = jcoco.CocoClsDataset(root, bare, "train", crop_size=64)
    with_table = tcoco.CocoClsDataset(root, lists, "train", crop_size=64)
    assert t.label_list is None and j.label_list is None
    for i in range(len(t)):
        a, b = t.__getitem__(i, seed=2), j.__getitem__(i, seed=2)
        _equal(a, b)
        np.testing.assert_array_equal(
            a["cls_label"], with_table.__getitem__(i, seed=2)["cls_label"])


def test_label_folder_and_sizes(tree, tmp_path):
    """An explicit mask root, and ``image_size`` from the JPEG header."""
    out, root, lists = tree
    moved = str(tmp_path / "masks")
    shutil.copytree(os.path.join(out, "SegmentationClass"), moved)
    t = tcoco.CocoSegDataset(root, lists, label_folder=moved)
    j = jcoco.CocoSegDataset(root, lists, label_folder=moved)
    assert t.label_folder == moved
    _equal(t[1], j[1])
    sizes = [t.image_size(i) for i in range(len(t))]
    assert sizes == [np.asarray(Image.open(os.path.join(
        root, "val2014", n + ".jpg"))).shape[:2] for n in t.name_list]


def test_write_synthetic_coco_is_seeded(tmp_path):
    """One seed writes the same files; the one-hot table has COCO's 80
    classes and matches each mask."""
    trees = [tcoco.write_synthetic_coco(str(tmp_path / d), [(48, 64)],
                                        [(64, 48)], seed=s)
             for d, s in (("a", 5), ("b", 5), ("c", 6))]
    rel = os.path.join("train2014", "COCO_train2014_000000000000.jpg")
    data = [open(os.path.join(root, rel), "rb").read() for root, _ in trees]
    assert data[0] == data[1] and data[0] != data[2]
    root, lists = trees[0]
    s = tcoco.CocoClsDataset(root, lists, "train", crop_size=32).__getitem__(
        0, seed=0)
    assert s["image"].shape == (32, 32, 3) and s["cls_label"].shape == (80,)
    mask = np.asarray(Image.open(os.path.join(
        tmp_path, "a", "SegmentationClass", "train2014",
        "COCO_train2014_000000000000.png")))
    np.testing.assert_array_equal(s["cls_label"],
                                  tcoco.onehot_from_mask(mask, 81))
