"""PASCAL VOC 2012 (aug) datasets (counterpart of ``dupl_tpu/data/voc.py``;
reference: datasets/voc.py).

Plain-Python datasets (index -> sample dict of numpy arrays) consumed by
``data.pipeline.PrefetchLoader``.  Image-level labels come from
``cls_labels_onehot.npy`` keyed by image name; train items carry ``img_box``
marking the valid crop region.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

from dupl_tpu_torch.data import transforms

VOC_CLASS_LIST = (
    "bg", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "table", "dog", "horse", "motorbike", "person", "plant",
    "sheep", "sofa", "train", "tvmonitor",
)


def load_name_list(path: str):
    with open(path) as f:
        return [x.strip() for x in f if x.strip()]


def load_cls_labels(name_list_dir: str) -> Dict[str, np.ndarray]:
    return np.load(
        os.path.join(name_list_dir, "cls_labels_onehot.npy"), allow_pickle=True
    ).item()


def onehot_from_mask(mask: np.ndarray, num_classes: int,
                     ignore_index: int = 255) -> np.ndarray:
    """Image-level multi-hot from a seg mask, excluding bg and ignore
    (reference: datasets/voc.py:154-165).  Output indexes foreground classes
    0..C-2."""
    labels = np.unique(mask).astype(np.int32)
    labels = labels[(labels != ignore_index) & (labels != 0)]
    onehot = np.zeros(num_classes - 1, np.float32)
    onehot[labels - 1] = 1
    return onehot


class VocDatasetBase:
    def __init__(self, root_dir: str, name_list_dir: str, split: str):
        self.root_dir = root_dir
        self.img_dir = os.path.join(root_dir, "JPEGImages")
        self.label_dir = os.path.join(root_dir, "SegmentationClassAug")
        self.split = split
        self.name_list = load_name_list(os.path.join(name_list_dir, split + ".txt"))

    def __len__(self):
        return len(self.name_list)

    def read_image(self, name: str) -> np.ndarray:
        img = Image.open(os.path.join(self.img_dir, name + ".jpg")).convert("RGB")
        return np.asarray(img)

    def image_size(self, idx: int) -> Tuple[int, int]:
        """(h, w) from the JPEG header, no pixel decode.  The
        native-resolution evaluator buckets same-shape images with it."""
        with Image.open(os.path.join(self.img_dir, self.name_list[idx] + ".jpg")) as im:
            w, h = im.size
        return (h, w)

    def read_label(self, name: str) -> np.ndarray:
        return np.asarray(Image.open(os.path.join(self.label_dir, name + ".png")))


class VocClsDataset(VocDatasetBase):
    """Training dataset: image + image-level labels + img_box (reference:
    VOC12ClsDataset, datasets/voc.py:65-188).  The reference also emits DINO
    crops (global_view2/local_view) that its trainer discards
    (train_final_voc.py:180); they are not reproduced."""

    def __init__(self, root_dir: str, name_list_dir: str, split: str = "train_aug",
                 crop_size: int = 448, rescale_range: Tuple[float, float] = (0.5, 2.0),
                 img_fliplr: bool = True, num_classes: int = 21,
                 ignore_index: int = 255, aug: bool = True,
                 transfer_dtype: str = "float32"):
        super().__init__(root_dir, name_list_dir, split)
        self.crop_size = crop_size
        self.rescale_range = rescale_range
        self.img_fliplr = img_fliplr
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.aug = aug
        self.transfer_dtype = transfer_dtype
        self.label_list = load_cls_labels(name_list_dir)

    def __getitem__(self, idx: int, seed: Optional[int] = None) -> Dict:
        name = self.name_list[idx]
        image = self.read_image(name)
        rng = random.Random(seed)
        cls_label = np.asarray(self.label_list[name], np.float32)
        if self.aug:
            image, img_box = transforms.train_transform(
                image, self.crop_size, self.rescale_range, rng,
                fliplr=self.img_fliplr, ignore_index=self.ignore_index,
                transfer_dtype=self.transfer_dtype,
            )
        else:
            image = transforms.normalize_img(image)
            img_box = np.asarray([0, image.shape[0], 0, image.shape[1]], np.int32)
        return {"name": name, "image": image, "cls_label": cls_label, "img_box": img_box}


class VocSegDataset(VocDatasetBase):
    """Validation/eval dataset: image + seg mask + image-level labels
    (reference: VOC12SegDataset, datasets/voc.py:191-247; val path =
    normalize only)."""

    def __init__(self, root_dir: str, name_list_dir: str, split: str = "val",
                 stage: str = "val", num_classes: int = 21, ignore_index: int = 255,
                 transfer_dtype: str = "float32"):
        super().__init__(root_dir, name_list_dir, split)
        self.stage = stage
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.transfer_dtype = transfer_dtype

    def __getitem__(self, idx: int, seed: Optional[int] = None) -> Dict:
        name = self.name_list[idx]
        image = self.read_image(name)
        if self.stage == "test":
            label = image[:, :, 0]
        else:
            label = self.read_label(name)
        cls_label = onehot_from_mask(label, self.num_classes, self.ignore_index)
        return {
            "name": name,
            # uint8 wire format: consumers normalise on the device
            # (ops.image.prepare_inputs) and the image crosses at 1/4 bytes
            "image": (image if self.transfer_dtype == "uint8"
                      else transforms.normalize_img(image)),
            "raw_image": image,
            "label": label.astype(np.int32),
            "cls_label": cls_label,
        }


def _rect_scene(rs: np.random.RandomState, h: int, w: int, num_fg: int):
    """A flat background with three coloured rectangles of random foreground
    classes, a few ignore pixels, and noise: (uint8 image, uint8 mask)."""
    img = np.full((h, w, 3), rs.randint(0, 255, 3), np.uint8)
    mask = np.zeros((h, w), np.uint8)
    for _ in range(3):
        y0, x0 = rs.randint(0, h // 2), rs.randint(0, w // 2)
        y1 = y0 + rs.randint(h // 4, h // 2)
        x1 = x0 + rs.randint(w // 4, w // 2)
        img[y0:y1, x0:x1] = rs.randint(0, 255, 3)
        mask[y0:y1, x0:x1] = rs.randint(1, num_fg + 1)
    mask[0, :4] = 255
    img = np.clip(img.astype(np.int16) + rs.randint(-6, 6, img.shape),
                  0, 255).astype(np.uint8)
    return img, mask


def write_synthetic_voc(root: str, sizes, seed: int = 0, num_fg: int = 20,
                        split: str = "val", train_sizes=None,
                        train_split: str = "train_aug",
                        style: str = "rect") -> Tuple[str, str]:
    """Write a VOC-structured tree of synthetic scenes: one JPEG and one
    mask PNG per (h, w) of ``sizes``, the name list ``lists/<split>.txt`` and
    ``lists/cls_labels_onehot.npy``.  With ``train_sizes`` a second list
    ``lists/<train_split>.txt`` of that many further scenes is written, so
    one call makes a tree the training tool can train and validate on.
    ``style="rect"``: a flat background with three coloured rectangles of
    random foreground classes (the mask is their ground truth), a few ignore
    pixels, and noise; ``style="photo"``: the natural-statistics scenes of
    ``data.pipeline.photo_scene``.  For smoke runs, profiles and tests;
    returns (root, list folder)."""
    if style not in ("rect", "photo"):
        raise ValueError(f"style must be 'rect' or 'photo', got {style!r}")
    img_dir = os.path.join(root, "JPEGImages")
    seg_dir = os.path.join(root, "SegmentationClassAug")
    lists = os.path.join(root, "lists")
    for d in (img_dir, seg_dir, lists):
        os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(seed)
    labels = {}
    splits = [(split, list(sizes))]
    if train_sizes is not None:
        splits.append((train_split, list(train_sizes)))
    i = 0
    for split_name, split_sizes in splits:
        names = []
        for h, w in split_sizes:
            name = f"2007_{i:06d}"
            i += 1
            if style == "photo":
                from dupl_tpu_torch.data.pipeline import photo_scene

                img, mask = photo_scene(rs, h, w, num_fg)
                mask = mask.astype(np.uint8)
            else:
                img, mask = _rect_scene(rs, h, w, num_fg)
            Image.fromarray(img).save(os.path.join(img_dir, name + ".jpg"))
            Image.fromarray(mask).save(os.path.join(seg_dir, name + ".png"))
            labels[name] = onehot_from_mask(mask, num_fg + 1)
            names.append(name)
        with open(os.path.join(lists, split_name + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    np.save(os.path.join(lists, "cls_labels_onehot.npy"), labels,
            allow_pickle=True)
    return root, lists
