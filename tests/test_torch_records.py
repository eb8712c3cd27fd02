"""Port parity for the packed-record format (``dupl_tpu_torch.data.records``
against ``dupl_tpu.data.records``, after tests/test_records.py): a split
packed by either package is the same bytes, each package reads the other's
shards, the record datasets give the directory datasets' samples byte for
byte, and the port's tools run."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from dupl_tpu.data import records as jrec
from dupl_tpu_torch.data import records as trec
from dupl_tpu_torch.data.coco import (CocoClsDataset, CocoSegDataset,
                                      write_synthetic_coco)
from dupl_tpu_torch.data.pipeline import PrefetchLoader
from dupl_tpu_torch.data.voc import (VocClsDataset, VocSegDataset,
                                     load_name_list, write_synthetic_voc)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SIZES = [(60, 80), (64, 64), (80, 60), (70, 70), (66, 90), (72, 64),
         (90, 66), (64, 72)]


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return write_synthetic_voc(str(tmp_path_factory.mktemp("voc")),
                               SIZES[:3], seed=4, train_sizes=SIZES)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return write_synthetic_coco(str(tmp_path_factory.mktemp("coco")),
                                SIZES[:3], SIZES[3:], seed=5)


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], (str, list)):     # a name, a batch's names
            assert a[k] == b[k], k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("dataset,split,shards", [
    ("voc", "train_aug", 1), ("voc", "val", 2), ("coco", "train", 1),
    ("coco", "val_part", 2)])
def test_both_packages_pack_the_same_bytes(voc, coco, tmp_path, dataset,
                                           split, shards):
    root, lists = voc if dataset == "voc" else coco
    a, b = str(tmp_path / "t.duplrec"), str(tmp_path / "j.duplrec")
    pack = {"voc": (trec.pack_voc, jrec.pack_voc),
            "coco": (trec.pack_coco, jrec.pack_coco)}[dataset]
    n = pack[0](root, lists, split, a, shards=shards)
    assert n == pack[1](root, lists, split, b, shards=shards)
    assert trec._sharded(a, shards) != [a] or shards == 1
    for pa, pb in zip(trec._sharded(a, shards), jrec._sharded(b, shards)):
        assert _bytes(pa) == _bytes(pb), (pa, pb)
    assert trec.MAGIC == jrec.MAGIC == b"DUPLREC1"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_shards(coco, tmp_path, writer):
    """A COCO split packed by one package: the other's store sees the same
    index, bytes and decoded pixels (the grayscale image included)."""
    root, lists = coco
    shard = str(tmp_path / "v.duplrec")
    (trec if writer == "port" else jrec).pack_coco(root, lists, "val_part",
                                                   shard)
    t, j = trec.RecordStore(shard), jrec.RecordStore(shard)
    assert t.names == j.names and t.sizes == j.sizes
    assert t.cls_labels.keys() == j.cls_labels.keys()
    for n in t.names:
        assert t.image_bytes(n) == j.image_bytes(n)
        assert t.label_bytes(n) == j.label_bytes(n)
        np.testing.assert_array_equal(t.decode_image(n), j.decode_image(n))
        np.testing.assert_array_equal(t.decode_label(n), j.decode_label(n))
        np.testing.assert_array_equal(t.cls_labels[n], j.cls_labels[n])
    assert t.decode_image(t.names[0]).shape[2] == 3
    t.close(), j.close()


def test_record_datasets_match_the_directory_datasets(voc, coco, tmp_path):
    """The four record datasets against the port's directory datasets for
    the same ``(idx, seed)``, and the JAX record datasets on the same
    shards."""
    vroot, vlists = voc
    croot, clists = coco
    shards = {}
    for name, pack, root, lists, split in (
            ("voc_tr", trec.pack_voc, vroot, vlists, "train_aug"),
            ("voc_va", trec.pack_voc, vroot, vlists, "val"),
            ("coco_tr", trec.pack_coco, croot, clists, "train"),
            ("coco_va", trec.pack_coco, croot, clists, "val_part")):
        shards[name] = str(tmp_path / f"{name}.duplrec")
        pack(root, lists, split, shards[name])
    kw = dict(crop_size=64, transfer_dtype="uint8")
    cases = [
        (trec.RecordVocClsDataset(shards["voc_tr"], **kw),
         jrec.RecordVocClsDataset(shards["voc_tr"], **kw),
         VocClsDataset(vroot, vlists, "train_aug", **kw), True),
        (trec.RecordVocSegDataset(shards["voc_va"]),
         jrec.RecordVocSegDataset(shards["voc_va"]),
         VocSegDataset(vroot, vlists, "val"), False),
        (trec.RecordCocoClsDataset(shards["coco_tr"], **kw),
         jrec.RecordCocoClsDataset(shards["coco_tr"], **kw),
         CocoClsDataset(croot, clists, "train", **kw), True),
        (trec.RecordCocoSegDataset(shards["coco_va"], transfer_dtype="uint8"),
         jrec.RecordCocoSegDataset(shards["coco_va"], transfer_dtype="uint8"),
         CocoSegDataset(croot, clists, "val_part", transfer_dtype="uint8"),
         False)]
    for rec, jax_rec, direct, seeded in cases:
        assert rec.name_list == direct.name_list and len(rec) == len(direct)
        for i in range(len(direct)):
            kw_ = dict(seed=7 + i) if seeded else {}
            got = rec.__getitem__(i, **kw_)
            _equal(got, direct.__getitem__(i, **kw_))
            _equal(got, jax_rec.__getitem__(i, **kw_))
            assert rec.image_size(i) == direct.image_size(i)


def test_coco_records_without_cls_labels(coco, tmp_path):
    """Packed without the one-hot table, the COCO training dataset derives
    the labels from the packed masks, as the directory dataset does; VOC's
    refuses."""
    root, lists = coco
    shard = str(tmp_path / "nocls.duplrec")
    trec.pack_coco(root, lists, "train", shard, with_cls=False)
    rec = trec.RecordCocoClsDataset(shard, crop_size=64)
    assert rec.label_list is None
    direct = CocoClsDataset(root, lists, "train", crop_size=64)
    for i in range(len(direct)):
        np.testing.assert_array_equal(rec.__getitem__(i, seed=1)["cls_label"],
                                      direct.__getitem__(i, seed=1)["cls_label"])
    with pytest.raises(ValueError, match="without cls labels"):
        trec.RecordVocClsDataset(shard)


def test_sharded_pack_and_glob_read(voc, tmp_path):
    root, lists = voc
    single = str(tmp_path / "one.duplrec")
    trec.pack_voc(root, lists, "train_aug", single)
    assert trec.pack_voc(root, lists, "train_aug",
                         str(tmp_path / "many.duplrec"), shards=3) == 8
    names = sorted(os.listdir(tmp_path))
    assert "many-00000-of-00003.duplrec" in names
    assert "many-00002-of-00003.duplrec" in names
    glob_ = str(tmp_path / "many-*.duplrec")
    one, many = trec.RecordStore(single), trec.RecordStore(glob_)
    assert many.names == one.names and many.sizes == one.sizes
    assert many.path.endswith("(+2)")
    listed = trec.RecordStore(sorted(
        str(tmp_path / n) for n in names if n.startswith("many-")))
    assert listed.names == one.names
    direct = VocClsDataset(root, lists, "train_aug", crop_size=64)
    rec = trec.RecordVocClsDataset(glob_, crop_size=64)
    for i in range(len(direct)):
        _equal(rec.__getitem__(i, seed=9 + i), direct.__getitem__(i, seed=9 + i))
    with pytest.raises(FileNotFoundError, match="no shards match"):
        trec.RecordStore(str(tmp_path / "absent-*.duplrec"))
    with pytest.raises(FileNotFoundError):
        trec.RecordStore(str(tmp_path / "absent.duplrec"))


def test_load_time_refusals(voc, tmp_path):
    """Inconsistent with_cls, inconsistent with_labels, overlapping
    packings and a file that is not a shard all fail when the store is
    built, in both packages alike."""
    root, lists = voc
    names = load_name_list(os.path.join(lists, "train_aug.txt"))
    img = [os.path.join(root, "JPEGImages", n + ".jpg") for n in names]
    lab = [os.path.join(root, "SegmentationClassAug", n + ".png")
           for n in names]
    cls = {n: np.zeros(20, np.float32) for n in names}
    a, b_nocls, b_nolab, full = (str(tmp_path / f"{n}.duplrec") for n in
                                 ("a", "b_nocls", "b_nolab", "full"))
    trec.pack_records(a, names[:4], img[:4], lab[:4], cls)
    trec.pack_records(b_nocls, names[4:], img[4:], lab[4:], None)
    trec.pack_records(b_nolab, names[4:], img[4:], None, cls)
    trec.pack_voc(root, lists, "train_aug", full)
    junk = str(tmp_path / "junk.duplrec")
    with open(junk, "wb") as f:
        f.write(b"NOTAREC!" + b"\0" * 16)
    for mod in (trec, jrec):
        for paths, msg in (([a, b_nocls], "inconsistent with_cls"),
                           ([b_nocls, a], "inconsistent with_cls"),
                           ([a, b_nolab], "inconsistent with_labels"),
                           ([full, a], "duplicate sample name"),
                           (junk, "not a duplrec shard")):
            with pytest.raises(ValueError, match=msg):
                mod.RecordStore(paths)
    with pytest.raises(ValueError, match="length mismatch"):
        trec.pack_records(a, names, img[:2])


def test_bare_shard_guards(tmp_path):
    """A shard of images only: sizes from the index, the image decoded, a
    clear error for a mask or for cls training; ``close`` frees the
    descriptors."""
    path = tmp_path / "img.jpg"
    Image.fromarray(np.zeros((8, 12, 3), np.uint8)).save(path)
    bare = str(tmp_path / "bare.duplrec")
    index = trec.pack_records(bare, ["a"], [str(path)])
    assert index == {"format": "duplrec/1", "count": 1, "entries": [
        {"name": "a", "image": [0, os.path.getsize(path)], "size": [8, 12]}]}
    store = trec.RecordStore(bare)
    assert store.sizes == [(8, 12)] and store.cls_labels is None
    np.testing.assert_array_equal(store.decode_image("a"),
                                  np.asarray(Image.open(path).convert("RGB")))
    with pytest.raises(KeyError, match="no mask packed"):
        store.label_bytes("a")
    store.close()
    assert store._fds == []
    with pytest.raises(ValueError, match="without cls labels"):
        trec.RecordVocClsDataset(bare)


def test_records_through_the_prefetch_loader(coco, tmp_path):
    """Batch k is a pure function of (seed, k) whatever the storage: the
    loader over a glob of shards gives the directory feed's batches, with
    its worker threads sharing each shard's descriptor."""
    root, lists = coco
    trec.pack_coco(root, lists, "train", str(tmp_path / "tr.duplrec"),
                   shards=2)

    def take(ds, k=3):
        loader = PrefetchLoader(ds, 2, seed=11, num_workers=3)
        try:
            it = iter(loader)
            return [next(it) for _ in range(k)]
        finally:
            loader.stop()

    kw = dict(crop_size=64, transfer_dtype="uint8")
    got = take(trec.RecordCocoClsDataset(str(tmp_path / "tr-*.duplrec"), **kw))
    want = take(CocoClsDataset(root, lists, "train", **kw))
    for a, b in zip(got, want):
        _equal(a, b)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pack_records_cli(coco, voc, tmp_path, capsys):
    """``tools/pack_records_torch.py`` writes the library's shards."""
    root, lists = coco
    out = str(tmp_path / "cli.duplrec")
    assert _tool("pack_records_torch").main(
        ["--dataset", "coco", "--data-folder", root, "--list-folder", lists,
         "--split", "train", "--out", out, "--shards", "2"]) == 0
    assert "packed 5 samples (coco/train)" in capsys.readouterr().out
    lib = str(tmp_path / "lib.duplrec")
    trec.pack_coco(root, lists, "train", lib, shards=2)
    for a, b in zip(trec._sharded(out, 2), trec._sharded(lib, 2)):
        assert _bytes(a) == _bytes(b)
    vroot, vlists = voc
    assert _tool("pack_records_torch").main(
        ["--data-folder", vroot, "--list-folder", vlists, "--split", "val",
         "--out", out, "--no-masks", "--no-cls"]) == 0
    store = trec.RecordStore(out)
    assert len(store) == 3 and store.cls_labels is None
    with pytest.raises(KeyError):
        store.label_bytes(store.names[0])


@pytest.mark.parametrize("dataset", ["voc", "coco"])
def test_gen_cls_labels_cli_matches_the_table(voc, coco, tmp_path, dataset):
    """``tools/gen_cls_labels_torch.py`` rebuilds the one-hot table from the
    masks: the written file's entries equal the tree's."""
    import shutil

    root, lists = voc if dataset == "voc" else coco
    copy = str(tmp_path / "lists")
    shutil.copytree(lists, copy)
    os.remove(os.path.join(copy, "cls_labels_onehot.npy"))
    splits = ["train_aug", "val"] if dataset == "voc" else ["train",
                                                            "val_part"]
    assert _tool("gen_cls_labels_torch").main(
        ["--dataset", dataset, "--data-folder", root, "--list-folder", copy,
         "--splits", *splits]) == 0
    got = np.load(os.path.join(copy, "cls_labels_onehot.npy"),
                  allow_pickle=True).item()
    want = np.load(os.path.join(lists, "cls_labels_onehot.npy"),
                   allow_pickle=True).item()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.uint8
        np.testing.assert_array_equal(got[k], want[k])


def test_bench_records_runs(tmp_path, capsys):
    """``tools/bench_records_torch.py`` at a tiny size: both feeds measured
    (the numbers mean nothing here)."""
    res = _tool("bench_records_torch").main(
        ["--n-images", "8", "--size", "48", "--batch", "2", "--workers", "2",
         "--batches", "2", "--crop-size", "32",
         "--keep", str(tmp_path / "work")])
    assert res["directory_samples_per_s"] > 0
    assert res["records_samples_per_s"] > 0
    assert "packed shard:" in capsys.readouterr().out
