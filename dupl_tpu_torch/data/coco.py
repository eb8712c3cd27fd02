"""MS COCO 2014 datasets with VOC-style masks (counterpart of
``dupl_tpu/data/coco.py``; reference: datasets/coco.py).

The VOC datasets' structure with COCO's specifics: 81 classes, images split
across ``train2014`` / ``val2014`` subdirectories by the name's prefix
(coco.py:61-71), grayscale JPEGs promoted to three channels
(``robust_read_image``, coco.py:24-28), masks under
``SegmentationClass/{train2014,val2014}``.  For the same ``(idx, seed)`` a
sample equals the JAX package's byte for byte.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from dupl_tpu_torch.data import transforms
from dupl_tpu_torch.data.voc import (_rect_scene, load_cls_labels,
                                     load_name_list, onehot_from_mask)


def _subdir(name: str) -> str:
    return "train2014" if "train" in name else "val2014"


def default_label_folder(root_dir: str) -> str:
    """Mask root when no label folder is given: the ``SegmentationClass``
    sibling of the image root (the reference's layout, README.md:62-74).
    The record packer uses it too, so packed and directory feeds read the
    same masks."""
    return os.path.join(os.path.dirname(root_dir.rstrip("/")),
                        "SegmentationClass")


class CocoDatasetBase:
    def __init__(self, root_dir: str, name_list_dir: str, split: str,
                 label_folder: Optional[str] = None):
        self.root_dir = root_dir
        self.label_folder = label_folder or default_label_folder(root_dir)
        self.name_list = load_name_list(os.path.join(name_list_dir,
                                                     split + ".txt"))

    def __len__(self):
        return len(self.name_list)

    def _image_path(self, name: str) -> str:
        return os.path.join(self.root_dir, _subdir(name), name + ".jpg")

    def read_image(self, name: str) -> np.ndarray:
        # grayscale JPEGs become RGB (coco.py:24-28)
        return np.asarray(Image.open(self._image_path(name)).convert("RGB"))

    def read_label(self, name: str) -> np.ndarray:
        return np.asarray(Image.open(
            os.path.join(self.label_folder, _subdir(name), name + ".png")))

    def image_size(self, idx: int) -> Tuple[int, int]:
        """(h, w) from the JPEG header, no pixel decode (shape bucketing)."""
        with Image.open(self._image_path(self.name_list[idx])) as im:
            w, h = im.size
        return (h, w)


class CocoClsDataset(CocoDatasetBase):
    """Training dataset: image + image-level labels + img_box.  The labels
    come from ``cls_labels_onehot.npy``, or from the mask when that file is
    absent (it is not in the reference's snapshot;
    ``tools/gen_cls_labels_torch.py`` writes it)."""

    def __init__(self, root_dir: str, name_list_dir: str, split: str = "train",
                 crop_size: int = 448, rescale_range: Tuple[float, float] = (0.5, 2.0),
                 img_fliplr: bool = True, num_classes: int = 81,
                 ignore_index: int = 255, aug: bool = True,
                 label_folder: Optional[str] = None,
                 transfer_dtype: str = "float32"):
        super().__init__(root_dir, name_list_dir, split, label_folder)
        self.crop_size = crop_size
        self.rescale_range = rescale_range
        self.img_fliplr = img_fliplr
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.aug = aug
        self.transfer_dtype = transfer_dtype
        try:
            self.label_list = load_cls_labels(name_list_dir)
        except FileNotFoundError:
            self.label_list = None

    def __getitem__(self, idx: int, seed: Optional[int] = None) -> Dict:
        name = self.name_list[idx]
        image = self.read_image(name)
        rng = random.Random(seed)
        if self.label_list is not None:
            cls_label = np.asarray(self.label_list[name], np.float32)
        else:
            cls_label = onehot_from_mask(
                self.read_label(name), self.num_classes, self.ignore_index)
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


class CocoSegDataset(CocoDatasetBase):
    """Validation / evaluation dataset: image + mask + image-level labels."""

    def __init__(self, root_dir: str, name_list_dir: str, split: str = "val_part",
                 stage: str = "val", num_classes: int = 81, ignore_index: int = 255,
                 label_folder: Optional[str] = None,
                 transfer_dtype: str = "float32"):
        super().__init__(root_dir, name_list_dir, split, label_folder)
        self.stage = stage
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.transfer_dtype = transfer_dtype

    def __getitem__(self, idx: int, seed: Optional[int] = None) -> Dict:
        name = self.name_list[idx]
        image = self.read_image(name)
        label = self.read_label(name) if self.stage != "test" else image[:, :, 0]
        cls_label = onehot_from_mask(label, self.num_classes, self.ignore_index)
        return {
            "name": name,
            "image": (image if self.transfer_dtype == "uint8"
                      else transforms.normalize_img(image)),
            "raw_image": image,
            "label": label.astype(np.int32),
            "cls_label": cls_label,
        }


def write_synthetic_coco(out: str, val_sizes: Sequence[Tuple[int, int]],
                         train_sizes: Sequence[Tuple[int, int]] = (),
                         seed: int = 0) -> Tuple[str, str]:
    """Write a COCO-2014-structured tree of synthetic scenes, in the layout
    the datasets read (that of ``tools/make_fake_coco.py``):

        out/coco2014/{train2014,val2014}/COCO_<sub>_NNNNNNNNNNNN.jpg
        out/SegmentationClass/{train2014,val2014}/....png
        out/lists/{train,val,val_part}.txt, cls_labels_onehot.npy

    one rectangle scene over COCO's 80 foreground classes per (h, w) of
    ``train_sizes`` and ``val_sizes``; val image 0 is a grayscale JPEG.
    Returns (image root ``out/coco2014``, list folder)."""
    num_fg = 80
    root = os.path.join(out, "coco2014")
    seg_root = os.path.join(out, "SegmentationClass")
    lists = os.path.join(out, "lists")
    os.makedirs(lists, exist_ok=True)
    rs = np.random.RandomState(seed)
    labels = {}
    names = {}
    for sub, sizes in (("train2014", train_sizes), ("val2014", val_sizes)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        os.makedirs(os.path.join(seg_root, sub), exist_ok=True)
        names[sub] = []
        for i, (h, w) in enumerate(sizes):
            name = f"COCO_{sub}_{i:012d}"
            img, mask = _rect_scene(rs, h, w, num_fg)
            pil = Image.fromarray(img)
            if sub == "val2014" and i == 0:
                pil = pil.convert("L")
            pil.save(os.path.join(root, sub, name + ".jpg"))
            Image.fromarray(mask).save(os.path.join(seg_root, sub, name + ".png"))
            labels[name] = onehot_from_mask(mask, num_fg + 1)
            names[sub].append(name)
    for split, sub in (("train", "train2014"), ("val", "val2014"),
                       ("val_part", "val2014")):
        with open(os.path.join(lists, split + ".txt"), "w") as f:
            f.write("\n".join(names[sub]) + "\n")
    np.save(os.path.join(lists, "cls_labels_onehot.npy"), labels,
            allow_pickle=True)
    return root, lists
