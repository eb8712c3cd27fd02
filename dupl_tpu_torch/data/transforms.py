"""Host-side image transforms (counterpart of
``dupl_tpu/data/transforms.py``; numpy/PIL).  Only what evaluation needs is
here; the training augmentation follows with the data pipeline."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def normalize_img(img: np.ndarray) -> np.ndarray:
    """uint8 HWC [0,255] -> ImageNet-normalised float32
    (reference: datasets/transforms.py:45-52)."""
    out = np.empty(img.shape, np.float32)
    for c in range(3):
        out[..., c] = (img[..., c] - IMAGENET_MEAN[c]) / IMAGENET_STD[c]
    return out


def train_transform(*args, **kwargs):
    """The training augmentation (rescale, flip, crop); not ported yet."""
    raise NotImplementedError(
        "train_transform is not ported yet: it comes with the data pipeline")
