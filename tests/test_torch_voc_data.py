"""Port parity: dupl_tpu_torch.data.{voc,transforms} against
dupl_tpu.data.{voc,transforms} on one tree written to ``tmp_path`` (numpy and
PIL on both sides: exact)."""

import numpy as np
import pytest
import torch

from dupl_tpu.data import transforms as jtr
from dupl_tpu.data import voc as jvoc
from dupl_tpu_torch.data import transforms as ttr
from dupl_tpu_torch.data import voc as tvoc

torch.set_num_threads(2)

SIZES = [(48, 80), (80, 48), (64, 64), (48, 80)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    return tvoc.write_synthetic_voc(str(root), SIZES, seed=3)


def test_constants_and_normalize_match_jax():
    assert tvoc.VOC_CLASS_LIST == jvoc.VOC_CLASS_LIST
    assert ttr.IMAGENET_MEAN == jtr.IMAGENET_MEAN
    assert ttr.IMAGENET_STD == jtr.IMAGENET_STD
    img = np.random.RandomState(0).randint(0, 256, (20, 30, 3)).astype(np.uint8)
    got = ttr.normalize_img(img)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jtr.normalize_img(img))


def test_tree_readers_match_jax(tree):
    root, lists = tree
    names = tvoc.load_name_list(lists + "/val.txt")
    assert names == jvoc.load_name_list(lists + "/val.txt")
    assert len(names) == len(SIZES)
    tl, jl = tvoc.load_cls_labels(lists), jvoc.load_cls_labels(lists)
    assert tl.keys() == jl.keys() == set(names)
    for n in names:
        np.testing.assert_array_equal(tl[n], jl[n])


def test_onehot_from_mask_matches_jax():
    mask = np.zeros((8, 8), np.uint8)
    mask[:2], mask[2:4], mask[7] = 3, 20, 255
    got = tvoc.onehot_from_mask(mask, 21)
    np.testing.assert_array_equal(got, jvoc.onehot_from_mask(mask, 21))
    assert got.sum() == 2 and got[2] == 1 and got[19] == 1


@pytest.mark.parametrize("transfer_dtype", ["float32", "uint8"])
def test_seg_dataset_matches_jax(tree, transfer_dtype):
    root, lists = tree
    kw = dict(stage="val", transfer_dtype=transfer_dtype)
    td = tvoc.VocSegDataset(root, lists, "val", **kw)
    jd = jvoc.VocSegDataset(root, lists, "val", **kw)
    assert len(td) == len(jd) == len(SIZES)
    for i, size in enumerate(SIZES):
        assert td.image_size(i) == jd.image_size(i) == size
        a, b = td[i], jd[i]
        assert a.keys() == b.keys()
        assert a["name"] == b["name"]
        for k in ("image", "raw_image", "label", "cls_label"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
        assert a["image"].dtype == np.dtype(transfer_dtype)
        assert a["label"].shape == size


def test_synthetic_tree_labels_agree_with_its_masks(tree):
    root, lists = tree
    ds = tvoc.VocSegDataset(root, lists, "val")
    labels = tvoc.load_cls_labels(lists)
    for i in range(len(ds)):
        s = ds[i]
        np.testing.assert_array_equal(labels[s["name"]], s["cls_label"])
        assert (s["label"] == 255).sum() == 4 and s["cls_label"].sum() >= 1


def test_training_pieces_wait_for_the_data_pipeline(tree):
    """The training pieces waited for the data pipeline until it was ported;
    now they work: the training dataset reads the evaluation tree's split
    and crops as ``train_transform`` says (byte parity with the JAX package
    is in tests/test_torch_data.py)."""
    import random

    root, lists = tree
    ds = tvoc.VocClsDataset(root, lists, "val", crop_size=32)
    sample = ds.__getitem__(0, seed=3)
    assert sample["image"].shape == (32, 32, 3)
    assert sample["image"].dtype == np.float32 and sample["img_box"].shape == (4,)
    out, box = ttr.train_transform(np.zeros((8, 8, 3), np.uint8), 8, (0.5, 2.0),
                                   random.Random(0), transfer_dtype="uint8")
    assert out.shape == (8, 8, 3) and out.dtype == np.uint8
    assert 0 <= box[0] < box[1] <= 8 and 0 <= box[2] < box[3] <= 8
