"""Port parity of the data pipeline (dupl_tpu_torch/data) against
dupl_tpu.data: the same seeds must give the same bytes, from the single
transforms up to the loader's batch stream; and the torch device feeder on
the CPU."""

import random
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from dupl_tpu.data import pipeline as jpipe
from dupl_tpu.data import transforms as jtf
from dupl_tpu.data import voc as jvoc
from dupl_tpu_torch.data import pipeline as tpipe
from dupl_tpu_torch.data import transforms as ttf
from dupl_tpu_torch.data import voc as tvoc

torch.set_num_threads(2)

TRAIN_SIZES = [(70, 90), (64, 64), (90, 70), (80, 80), (66, 99), (75, 75),
               (100, 60), (64, 96)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic VOC tree with 3 val and 8 train images."""
    root = str(tmp_path_factory.mktemp("voc"))
    return tvoc.write_synthetic_voc(root, [(60, 80)] * 3, seed=1,
                                    train_sizes=TRAIN_SIZES)


def _image(seed, h=90, w=120):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_train_transform_byte_equal(seed, dtype):
    img = _image(seed)
    a, abox = ttf.train_transform(img, 64, (0.5, 2.0), random.Random(seed),
                                  transfer_dtype=dtype)
    b, bbox = jtf.train_transform(img, 64, (0.5, 2.0), random.Random(seed),
                                  transfer_dtype=dtype)
    assert a.dtype == b.dtype == np.dtype(dtype) and a.shape == (64, 64, 3)
    assert np.array_equal(a, b) and np.array_equal(abox, bbox)


@pytest.mark.parametrize("seed", [0, 5])
def test_single_transforms_byte_equal(seed):
    """Each transform draws from the generator in the reference's order:
    equal results AND equal generator states afterwards."""
    img = _image(seed)
    label = np.random.RandomState(seed).randint(0, 4, img.shape[:2]).astype(np.uint8)
    for name, args, kw in (
            ("random_scaling", (img, label), {}),
            ("random_fliplr", (img, label), {}),
            ("random_crop", (img.astype(np.float32), label),
             {"crop_size": 64}),
            ("random_crop", (img[:40, :50].astype(np.float32),),
             {"crop_size": 64}),     # padded on both axes
            ("gaussian_blur", (Image.fromarray(img),), {}),
            ("color_jitter", (Image.fromarray(img),), {}),
    ):
        ra, rb = random.Random(seed), random.Random(seed)
        a = getattr(ttf, name)(*args, rng=ra, **kw)
        b = getattr(jtf, name)(*args, rng=rb, **kw)
        a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y)), name
        assert ra.getstate() == rb.getstate(), name
    assert np.array_equal(ttf.normalize_img(img), jtf.normalize_img(img))
    hue = Image.fromarray(img)
    assert np.array_equal(np.asarray(ttf._hue_shift(hue, 0.07)),
                          np.asarray(jtf._hue_shift(hue, 0.07)))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_voc_cls_dataset_matches_jax(tree, dtype):
    root, lists = tree
    kw = dict(crop_size=64, transfer_dtype=dtype)
    a = tvoc.VocClsDataset(root, lists, "train_aug", **kw)
    b = jvoc.VocClsDataset(root, lists, "train_aug", **kw)
    assert len(a) == len(b) == 8
    for idx, seed in ((0, 11), (3, 12), (7, 13)):
        sa, sb = a.__getitem__(idx, seed=seed), b.__getitem__(idx, seed=seed)
        assert sa["name"] == sb["name"]
        for k in ("image", "cls_label", "img_box"):
            assert sa[k].dtype == sb[k].dtype
            assert np.array_equal(sa[k], sb[k]), k
    plain = tvoc.VocClsDataset(root, lists, "train_aug", aug=False)[2]
    assert plain["image"].shape == (90, 70, 3)
    assert plain["img_box"].tolist() == [0, 90, 0, 70]


def test_synthetic_tree_has_both_splits_and_photo_style(tree, tmp_path):
    root, lists = tree
    assert len(tvoc.load_name_list(f"{lists}/val.txt")) == 3
    names = tvoc.load_name_list(f"{lists}/train_aug.txt")
    assert len(names) == 8 and set(names) <= set(tvoc.load_cls_labels(lists))
    # the val split of a tree with a train split is the tree without one
    only_val, _ = tvoc.write_synthetic_voc(str(tmp_path / "v"), [(60, 80)] * 3,
                                           seed=1)
    ds_a = tvoc.VocSegDataset(root, lists)
    ds_b = tvoc.VocSegDataset(only_val, f"{only_val}/lists")
    assert np.array_equal(ds_a[2]["image"], ds_b[2]["image"])
    photo, plists = tvoc.write_synthetic_voc(
        str(tmp_path / "p"), [(48, 64)], train_sizes=[(64, 48)], style="photo")
    sample = tvoc.VocSegDataset(photo, plists)[0]
    assert sample["image"].shape == (48, 64, 3) and sample["cls_label"].sum() >= 1


def _first_batches(loader, n):
    out = []
    for batch in loader:
        out.append(batch)
        if len(out) == n:
            break
    loader.stop()
    return out


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_prefetch_loader_batches_match_jax(tree, dtype):
    """Batch k for k < 6 (8 images, batch 2: two epochs, so the reshuffle is
    crossed), and ``start_step`` 3 gives batches 3, 4, 5 of the same
    stream."""
    root, lists = tree
    kw = dict(crop_size=64, transfer_dtype=dtype)
    ta = tvoc.VocClsDataset(root, lists, "train_aug", **kw)
    ja = jvoc.VocClsDataset(root, lists, "train_aug", **kw)
    got = _first_batches(tpipe.PrefetchLoader(ta, 2, seed=7, num_workers=3), 6)
    want = _first_batches(jpipe.PrefetchLoader(ja, 2, seed=7, num_workers=2), 6)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a["name"] == b["name"], k
        for key in ("image", "cls_label", "img_box"):
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key]), (k, key)
    assert {n for b in got[:4] for n in b["name"]} == set(ta.name_list)
    resumed = _first_batches(
        tpipe.PrefetchLoader(ta, 2, seed=7, num_workers=2, start_step=3), 3)
    for a, b in zip(resumed, got[3:]):
        assert a["name"] == b["name"]
        assert np.array_equal(a["image"], b["image"])


def test_prefetch_loader_shards_like_jax(tree):
    root, lists = tree
    ta = tvoc.VocClsDataset(root, lists, "train_aug", crop_size=64)
    a = tpipe.PrefetchLoader(ta, 2, seed=3, shard=1, num_shards=2)
    b = jpipe.PrefetchLoader(ta, 2, seed=3, shard=1, num_shards=2)
    for epoch in (0, 1):
        assert np.array_equal(a._epoch_order(epoch), b._epoch_order(epoch))
    whole = tpipe.PrefetchLoader(ta, 4, seed=3)._epoch_order(0).reshape(-1, 2, 2)
    assert np.array_equal(a._epoch_order(0), whole[:, 1].reshape(-1))


class _Failing:
    def __len__(self):
        return 8

    def __getitem__(self, idx, seed=None):
        if idx == 5:
            raise OSError("corrupt jpeg")
        return {"image": np.zeros((4, 4, 3), np.float32)}


def test_prefetch_loader_reraises_and_is_single_use(tree):
    with pytest.raises(RuntimeError, match="worker failed") as ei:
        for _ in tpipe.PrefetchLoader(_Failing(), 2, num_workers=2):
            pass
    assert isinstance(ei.value.__cause__, OSError)
    root, lists = tree
    ds = tvoc.VocClsDataset(root, lists, "train_aug", crop_size=64)
    loader = tpipe.PrefetchLoader(ds, 2, num_workers=1)
    _first_batches(loader, 1)
    with pytest.raises(RuntimeError, match="single-use"):
        next(iter(loader))
    with pytest.raises(RuntimeError, match="worker failed") as ei:
        next(iter(tpipe.PrefetchLoader(ds, 16)))
    assert isinstance(ei.value.__cause__, ValueError)   # no complete batch


@pytest.mark.parametrize("seed", [0, 4])
def test_photo_batch_byte_equal(seed):
    a = tpipe.synthetic_batch(2, crop=64, seed=seed, style="photo")
    b = jpipe.synthetic_batch(2, crop=64, seed=seed, style="photo")
    for k in ("image", "cls_label", "img_box"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    c = tpipe.synthetic_batch(2, crop=64, seed=seed)
    assert not np.array_equal(a["image"], c["image"])
    rs_a, rs_b = np.random.RandomState(seed), np.random.RandomState(seed)
    assert np.array_equal(tpipe.pink_texture(rs_a, 32, 48),
                          jpipe.pink_texture(rs_b, 32, 48))
    img = np.random.RandomState(seed).randint(0, 256, (32, 32, 3)).astype(np.uint8)
    assert np.array_equal(tpipe.jpeg_roundtrip(img), jpipe.jpeg_roundtrip(img))


def _numbered(n):
    for i in range(n):
        yield {"image": np.full((2, 4, 4, 3), i, np.uint8),
               "cls_label": np.eye(2, 20, dtype=np.float32),
               "img_box": np.zeros((2, 4), np.int32), "name": [f"a{i}", f"b{i}"]}


def test_device_feeder_order_keys_and_host_fn():
    feeder = tpipe.DeviceFeeder(
        _numbered(5), "cpu", keys=("image", "cls_label", "img_box"), depth=2,
        host_fn=lambda b: {"fits_budget": int(b["image"].max()) % 2 == 0})
    seen = []
    for host, dev in feeder:
        assert set(dev) == {"image", "cls_label", "img_box", "fits_budget"}
        assert isinstance(dev["image"], torch.Tensor)
        assert dev["image"].dtype == torch.uint8 and dev["image"].device.type == "cpu"
        assert host["name"][0] == f"a{len(seen)}"
        assert dev["fits_budget"] == (len(seen) % 2 == 0)
        seen.append(int(dev["image"][0, 0, 0, 0]))
    assert seen == [0, 1, 2, 3, 4]
    stats = feeder.stats()
    assert stats["batches"] == 5 and stats["copy_ms"] is None
    with pytest.raises(RuntimeError, match="single-use"):
        next(iter(feeder))


def test_device_feeder_stop_and_error():
    class Endless:
        stopped = False

        def __iter__(self):
            i = 0
            while not self.stopped:
                yield {"image": np.full((1, 2, 2, 3), i, np.uint8)}
                i += 1

        def stop(self):
            self.stopped = True

    src = Endless()
    feeder = tpipe.DeviceFeeder(src, "cpu", depth=2)
    it = iter(feeder)
    assert int(next(it)[1]["image"].max()) == 0
    feeder.stop()
    assert src.stopped
    assert list(it) == []
    deadline = time.time() + 5
    while feeder._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not feeder._thread.is_alive()

    def broken():
        yield {"image": np.zeros((1, 2, 2, 3), np.uint8)}
        raise OSError("disk gone")

    with pytest.raises(RuntimeError, match="device feeder") as ei:
        for _ in tpipe.DeviceFeeder(broken(), "cpu"):
            pass
    assert isinstance(ei.value.__cause__, OSError)
    assert threading.active_count() < 50
