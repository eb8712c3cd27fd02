"""Blob scenes: ``dupl_tpu_torch/data/pipeline.py:synthetic_batch``'s
scenes, copied here so that the program cannot move the yardstick:
``blocks`` x ``blocks`` colour blocks plus uniform noise of amplitude
``noise``, as uint8 ``crop`` x ``crop`` images.  Each image holds
``classes_per_image`` = [lo, hi] distinct foreground classes of ``num_fg``
(VOC images hold about 1.5), so that no image passes PAR's class budget
(``synthetic_batch``'s density could, for rare seeds, and switch a whole
batch to the wide class axis).  Every seed gives the same sizes; only the
pixels and the classes move.

Parameters: ``batch``, ``crop``, ``pool``, ``blocks``, ``noise``,
``num_fg``, ``classes_per_image``, ``img_box`` ([top, bottom, left, right]
of the valid crop).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def blob_images(r: np.random.Generator, n: int, crop: int, blocks: int,
                noise: float) -> np.ndarray:
    """uint8 (n, crop, crop, 3) blob scenes: each pixel its block's colour
    plus ``noise`` times a uniform draw, clipped to [0, 1], scaled to 255
    and rounded half to even (in place, a batch of 64 in under a second)."""
    tile = crop // blocks
    cells = r.random((n, blocks, blocks, 3), dtype=np.float32)
    img = r.random((n, crop, crop, 3), dtype=np.float32)
    img *= noise
    img.reshape(n, blocks, tile, blocks, tile, 3)[...] += \
        cells[:, :, None, :, None, :]
    np.clip(img, 0.0, 1.0, out=img)
    img *= 255.0
    np.rint(img, out=img)
    return img.astype(np.uint8)


def class_labels(r: np.random.Generator, n: int, num_fg: int, lo: int,
                 hi: int) -> np.ndarray:
    """float32 (n, num_fg) multi-hot labels, lo to hi classes an image."""
    out = np.zeros((n, num_fg), np.float32)
    counts = r.integers(lo, hi + 1, size=n)
    for i, k in enumerate(counts):
        out[i, r.choice(num_fg, size=int(k), replace=False)] = 1.0
    return out


def pool(traffic: dict, r: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    """``traffic['pool']`` batches, each ``{"images": uint8 (B, H, W, 3),
    "cls_label": float32 (B, num_fg), "img_box": int32 (B, 4)}``."""
    b, crop = traffic["batch"], traffic["crop"]
    lo, hi = traffic.get("classes_per_image", (1, 4))
    box = np.tile(np.asarray([traffic.get("img_box", (0, crop, 0, crop))],
                             np.int32), (b, 1))
    out = []
    for _ in range(traffic["pool"]):
        out.append({
            "images": blob_images(r, b, crop, traffic.get("blocks", 8),
                                  traffic.get("noise", 0.05)),
            "cls_label": class_labels(r, b, traffic.get("num_fg", 20), lo,
                                      hi),
            "img_box": box.copy()})
    return out
