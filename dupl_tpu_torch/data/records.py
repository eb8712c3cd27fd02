"""Packed-record input format ``.duplrec`` (counterpart of
``dupl_tpu/data/records.py``): a few large shards in place of two small
files a sample.

    DUPLREC1 | uint64 LE json_len | JSON index | blob section

The JSON index holds, per sample: the name, (offset, length) of the encoded
image bytes, optionally (offset, length) of the encoded mask bytes, the
image's (h, w) (so shape bucketing never reads a blob), and optionally the
image-level one-hot label.  Blobs are the original file bytes (JPEG / PNG,
neither decoded nor re-encoded), so packed and directory datasets give the
same pixels.  The format is the interface between the two packages: the
same split packed by either is the same bytes, and each reads the other's.

Reads go through one ``os.pread`` descriptor a shard: positionless and
thread-safe, so all ``PrefetchLoader`` worker threads share it without a
lock.  The ``Record*Dataset`` classes replace only the IO methods of the
directory datasets; their ``__getitem__`` (transforms, the ``(idx, seed)``
contract) is inherited unchanged.
"""

from __future__ import annotations

import glob
import io
import json
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from dupl_tpu_torch.data import coco as coco_data
from dupl_tpu_torch.data import voc as voc_data

MAGIC = b"DUPLREC1"


def pack_records(out_path: str, names: Sequence[str],
                 image_paths: Sequence[str],
                 label_paths: Optional[Sequence[Optional[str]]] = None,
                 cls_labels: Optional[Dict[str, np.ndarray]] = None) -> dict:
    """Write one ``.duplrec`` shard of raw file bytes; returns its index."""
    if label_paths is None:
        label_paths = [None] * len(names)
    if len(image_paths) != len(names) or len(label_paths) != len(names):
        raise ValueError("names/image_paths/label_paths length mismatch")

    # blobs stream to a side file (a COCO split is ~13 GB) and are copied in
    # after the index, whose length is known only once every entry is
    entries: List[dict] = []
    tmp = out_path + ".blobs.tmp"
    try:
        with open(tmp, "wb") as blobs:
            for name, ipath, lpath in zip(names, image_paths, label_paths):
                with open(ipath, "rb") as f:
                    ib = f.read()
                with Image.open(io.BytesIO(ib)) as im:
                    w, h = im.size
                e: dict = {"name": name, "image": [blobs.tell(), len(ib)],
                           "size": [h, w]}
                blobs.write(ib)
                if lpath is not None:
                    with open(lpath, "rb") as f:
                        lb = f.read()
                    e["label"] = [blobs.tell(), len(lb)]
                    blobs.write(lb)
                if cls_labels is not None:
                    e["cls"] = np.asarray(cls_labels[name], np.float32).tolist()
                entries.append(e)

        index = {"format": "duplrec/1", "count": len(entries),
                 "entries": entries}
        blob = json.dumps(index).encode("utf-8")
        with open(out_path, "wb") as f, open(tmp, "rb") as blobs:
            f.write(MAGIC)
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
            while True:
                chunk = blobs.read(1 << 24)
                if not chunk:
                    break
                f.write(chunk)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return index


def _sharded(out_path: str, shards: int) -> List[str]:
    """``x-00000-of-00004.duplrec`` ... for ``shards`` > 1."""
    if shards <= 1:
        return [out_path]
    stem, ext = os.path.splitext(out_path)
    return [f"{stem}-{i:05d}-of-{shards:05d}{ext}" for i in range(shards)]


def _pack_split(out_path: str, shards: int, names, img, lab, cls) -> int:
    paths = _sharded(out_path, shards)
    bounds = np.linspace(0, len(names), len(paths) + 1).astype(int)
    for p, lo, hi in zip(paths, bounds[:-1], bounds[1:]):
        pack_records(p, names[lo:hi], img[lo:hi],
                     None if lab is None else lab[lo:hi], cls)
    return len(names)


def pack_voc(root_dir: str, name_list_dir: str, split: str, out_path: str, *,
             with_labels: bool = True, with_cls: bool = True,
             shards: int = 1) -> int:
    """Pack a VOC split (JPEGImages, SegmentationClassAug,
    cls_labels_onehot.npy); ``shards`` > 1 writes contiguous
    ``-NNNNN-of-NNNNN`` pieces, read back with a glob.  Returns the sample
    count."""
    names = voc_data.load_name_list(os.path.join(name_list_dir, split + ".txt"))
    img = [os.path.join(root_dir, "JPEGImages", n + ".jpg") for n in names]
    lab = ([os.path.join(root_dir, "SegmentationClassAug", n + ".png")
            for n in names] if with_labels else None)
    cls = voc_data.load_cls_labels(name_list_dir) if with_cls else None
    return _pack_split(out_path, shards, names, img, lab, cls)


def pack_coco(root_dir: str, name_list_dir: str, split: str, out_path: str, *,
              label_folder: Optional[str] = None,
              with_labels: bool = True, with_cls: bool = True,
              shards: int = 1) -> int:
    """Pack a COCO split (``train2014`` / ``val2014`` by the name's prefix).
    Without ``cls_labels_onehot.npy`` the shard carries no labels and the
    datasets derive them from the packed masks."""
    names = voc_data.load_name_list(os.path.join(name_list_dir, split + ".txt"))
    label_folder = label_folder or coco_data.default_label_folder(root_dir)
    img = [os.path.join(root_dir, coco_data._subdir(n), n + ".jpg")
           for n in names]
    lab = ([os.path.join(label_folder, coco_data._subdir(n), n + ".png")
            for n in names] if with_labels else None)
    cls = None
    if with_cls:
        try:
            cls = voc_data.load_cls_labels(name_list_dir)
        except FileNotFoundError:
            cls = None
    return _pack_split(out_path, shards, names, img, lab, cls)


class RecordStore:
    """The read side: the index parsed once, then ``os.pread`` blob reads
    shared by the loader's threads.

    ``path`` is one shard, a glob (``voc-*.duplrec``) or a list of shards;
    several shards read as one dataset in shard order.  Refused at load
    time: a file without the magic, a sample name in two shards, and shards
    that disagree on carrying masks or cls labels."""

    def __init__(self, path):
        if isinstance(path, str):
            # a literal path wins over a glob, so a name with metacharacters
            # ('voc[2012].duplrec') still opens
            if os.path.exists(path):
                paths = [path]
            elif any(c in path for c in "*?["):
                paths = sorted(glob.glob(path))
                if not paths:
                    raise FileNotFoundError(f"no shards match {path!r}")
            else:
                raise FileNotFoundError(path)
        else:
            paths = list(path)
        self.path = paths[0] if len(paths) == 1 else f"{paths[0]} (+{len(paths) - 1})"
        self.entries: List[dict] = []
        self._fds: List[int] = []
        for shard_i, p in enumerate(paths):
            with open(p, "rb") as f:
                magic = f.read(len(MAGIC))
                if magic != MAGIC:
                    raise ValueError(
                        f"{p}: not a duplrec shard (magic {magic!r})")
                (n,) = struct.unpack("<Q", f.read(8))
                index = json.loads(f.read(n).decode("utf-8"))
                blob0 = f.tell()
            self._fds.append(os.open(p, os.O_RDONLY))
            for e in index["entries"]:
                e["_shard"] = shard_i
                e["_blob0"] = blob0
                self.entries.append(e)
        self.names: List[str] = [e["name"] for e in self.entries]
        self.sizes: List[Tuple[int, int]] = [tuple(e["size"]) for e in self.entries]
        self._by_name = {e["name"]: e for e in self.entries}
        if len(self._by_name) != len(self.entries):
            # e.g. a glob matching a whole-split shard and the pieces of the
            # same split: every sample would count twice
            dupes = len(self.entries) - len(self._by_name)
            raise ValueError(
                f"{self.path}: {dupes} duplicate sample name(s) across "
                "shards — the path/glob matches overlapping packings of "
                "the same split")
        n_lab = sum("label" in e for e in self.entries)
        if n_lab and n_lab != len(self.entries):
            raise ValueError(
                f"{self.path}: {n_lab}/{len(self.entries)} samples carry a "
                "mask — shards were packed with inconsistent with_labels; "
                "re-pack the split uniformly")
        self.cls_labels: Optional[Dict[str, np.ndarray]] = None
        n_cls = sum("cls" in e for e in self.entries)
        if n_cls and n_cls != len(self.entries):
            raise ValueError(
                f"{self.path}: {n_cls}/{len(self.entries)} samples carry a "
                "cls label — shards were packed with inconsistent with_cls; "
                "re-pack the split uniformly")
        if n_cls:
            self.cls_labels = {e["name"]: np.asarray(e["cls"], np.float32)
                               for e in self.entries}

    def __len__(self):
        return len(self.entries)

    def __del__(self):
        try:   # a dataset holds its store for life: free the descriptors
            self.close()   # when the store itself goes
        except Exception:
            pass

    def _read(self, e: dict, span) -> bytes:
        off, length = span
        return os.pread(self._fds[e["_shard"]], length, e["_blob0"] + off)

    def image_bytes(self, name: str) -> bytes:
        e = self._by_name[name]
        return self._read(e, e["image"])

    def label_bytes(self, name: str) -> bytes:
        e = self._by_name[name]
        if "label" not in e:
            raise KeyError(f"{self.path}: no mask packed for {name!r} "
                           "(packed with with_labels=False?)")
        return self._read(e, e["label"])

    def decode_image(self, name: str) -> np.ndarray:
        # .convert("RGB"): the directory datasets' grayscale promotion
        return np.asarray(Image.open(io.BytesIO(self.image_bytes(name))).convert("RGB"))

    def decode_label(self, name: str) -> np.ndarray:
        return np.asarray(Image.open(io.BytesIO(self.label_bytes(name))))

    def close(self):
        for fd in self._fds:
            os.close(fd)
        self._fds = []


class _RecordIO:
    """The three IO methods of a directory dataset, read from the store;
    first in the MRO, so the inherited ``__getitem__`` calls them."""

    _store: RecordStore

    def read_image(self, name: str) -> np.ndarray:
        return self._store.decode_image(name)

    def read_label(self, name: str) -> np.ndarray:
        return self._store.decode_label(name)

    def image_size(self, idx: int) -> Tuple[int, int]:
        return self._store.sizes[idx]


class RecordVocClsDataset(_RecordIO, voc_data.VocClsDataset):
    def __init__(self, record_path, *, crop_size: int = 448,
                 rescale_range: Tuple[float, float] = (0.5, 2.0),
                 img_fliplr: bool = True, num_classes: int = 21,
                 ignore_index: int = 255, aug: bool = True,
                 transfer_dtype: str = "float32"):
        self._store = RecordStore(record_path)
        if self._store.cls_labels is None:
            raise ValueError(f"{record_path} was packed without cls labels; "
                             "the training dataset needs them (pack with "
                             "with_cls=True)")
        self.name_list = list(self._store.names)
        self.label_list = self._store.cls_labels
        self.crop_size = crop_size
        self.rescale_range = rescale_range
        self.img_fliplr = img_fliplr
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.aug = aug
        self.transfer_dtype = transfer_dtype


class RecordVocSegDataset(_RecordIO, voc_data.VocSegDataset):
    def __init__(self, record_path, *, stage: str = "val",
                 num_classes: int = 21, ignore_index: int = 255,
                 transfer_dtype: str = "float32"):
        self._store = RecordStore(record_path)
        self.name_list = list(self._store.names)
        self.stage = stage
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.transfer_dtype = transfer_dtype


class RecordCocoClsDataset(_RecordIO, coco_data.CocoClsDataset):
    def __init__(self, record_path, *, crop_size: int = 448,
                 rescale_range: Tuple[float, float] = (0.5, 2.0),
                 img_fliplr: bool = True, num_classes: int = 81,
                 ignore_index: int = 255, aug: bool = True,
                 transfer_dtype: str = "float32"):
        self._store = RecordStore(record_path)
        self.name_list = list(self._store.names)
        # None: __getitem__ derives the one-hot from the packed mask, as the
        # directory dataset does without cls_labels_onehot.npy
        self.label_list = self._store.cls_labels
        self.crop_size = crop_size
        self.rescale_range = rescale_range
        self.img_fliplr = img_fliplr
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.aug = aug
        self.transfer_dtype = transfer_dtype


class RecordCocoSegDataset(_RecordIO, coco_data.CocoSegDataset):
    def __init__(self, record_path, *, stage: str = "val",
                 num_classes: int = 81, ignore_index: int = 255,
                 transfer_dtype: str = "float32"):
        self._store = RecordStore(record_path)
        self.name_list = list(self._store.names)
        self.stage = stage
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.transfer_dtype = transfer_dtype
