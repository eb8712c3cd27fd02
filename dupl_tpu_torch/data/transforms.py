"""Host-side image transforms (counterpart of
``dupl_tpu/data/transforms.py``; reference: datasets/transforms.py).

numpy/PIL ops that run in loader worker threads; everything that runs per
training step on the device lives in ``dupl_tpu_torch.ops``.  The train-time
chain: random scale in [0.5, 2] -> random hflip -> pad-to-crop random crop
that returns the valid-region ``img_box`` (with the 10-try ``cat_max_ratio``
box search when a label is given) -> photometric jitter -> blur ->
normalize.  Every draw comes from the ``random.Random`` handed in, in the
JAX package's order, so the same seed gives the same bytes in both.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageFilter

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def normalize_img(img: np.ndarray) -> np.ndarray:
    """uint8 HWC [0,255] -> ImageNet-normalised float32
    (reference: datasets/transforms.py:45-52)."""
    out = np.empty(img.shape, np.float32)
    for c in range(3):
        out[..., c] = (img[..., c] - IMAGENET_MEAN[c]) / IMAGENET_STD[c]
    return out


def random_scaling(image, label=None, scale_range=(0.5, 2.0), rng: random.Random = random):
    ratio = rng.uniform(*scale_range)
    h, w = image.shape[:2]
    size = (int(ratio * w), int(ratio * h))
    new_image = np.asarray(
        Image.fromarray(image.astype(np.uint8)).resize(size, Image.BILINEAR)
    ).astype(np.float32)
    if label is None:
        return new_image
    new_label = np.asarray(Image.fromarray(label).resize(size, Image.NEAREST))
    return new_image, new_label


def random_fliplr(image, label=None, rng: random.Random = random):
    if rng.random() > 0.5:
        image = np.fliplr(image)
        if label is not None:
            return image, np.fliplr(label)
    if label is not None:
        return image, label
    return image


def random_crop(
    image: np.ndarray,
    label: Optional[np.ndarray] = None,
    crop_size: int = 448,
    mean_rgb: Sequence[float] = (0, 0, 0),
    ignore_index: int = 255,
    cat_max_ratio: float = 0.75,
    rng: random.Random = random,
):
    """Pad to >= crop_size then random-crop; returns the crop plus ``img_box``
    = [h0, h1, w0, w1] coordinates of the *valid* (non-padding) region inside
    the crop (transforms.py:147-204).  With a label, up to 10 crop boxes are
    tried until no single class fills more than ``cat_max_ratio``."""
    h, w = image.shape[:2]
    H, W = max(crop_size, h), max(crop_size, w)

    pad_image = np.empty((H, W, 3), np.float32)
    pad_image[...] = np.asarray(mean_rgb, np.float32)
    h_pad = rng.randrange(0, H - h + 1)
    w_pad = rng.randrange(0, W - w + 1)
    pad_image[h_pad:h_pad + h, w_pad:w_pad + w] = image

    def sample_box():
        for _ in range(10):
            hs = rng.randrange(0, H - crop_size + 1)
            ws = rng.randrange(0, W - crop_size + 1)
            if label is None:
                return hs, ws
            crop_lab = pad_label[hs:hs + crop_size, ws:ws + crop_size]
            idx, cnt = np.unique(crop_lab, return_counts=True)
            cnt = cnt[idx != ignore_index]
            if cnt.size and cnt.max() / cnt.sum() < cat_max_ratio:
                return hs, ws
        return hs, ws

    if label is not None:
        pad_label = np.full((H, W), ignore_index, np.uint8)
        pad_label[h_pad:h_pad + h, w_pad:w_pad + w] = label

    hs, ws = sample_box()
    crop_image = pad_image[hs:hs + crop_size, ws:ws + crop_size]
    img_box = np.asarray([
        max(h_pad - hs, 0),
        min(crop_size, h + h_pad - hs),
        max(w_pad - ws, 0),
        min(crop_size, w + w_pad - ws),
    ], np.int32)

    if label is None:
        return crop_image, img_box
    crop_label = pad_label[hs:hs + crop_size, ws:ws + crop_size]
    return crop_image, crop_label, img_box


def gaussian_blur(img: Image.Image, p: float = 1.0,
                  radius_range=(0.1, 2.0), rng: random.Random = random) -> Image.Image:
    if rng.random() <= p:
        return img.filter(ImageFilter.GaussianBlur(rng.uniform(*radius_range)))
    return img


def color_jitter(img: Image.Image, rng: random.Random = random,
                 brightness=0.4, contrast=0.4, saturation=0.2, hue=0.1,
                 p: float = 0.8, grayscale_p: float = 0.2) -> Image.Image:
    """DINO-style photometric jitter of the train global view
    (datasets/voc.py:100-116): ColorJitter(p=0.8) + RandomGrayscale(p=0.2)."""
    from PIL import ImageEnhance

    if rng.random() < p:
        ops = [
            lambda im: ImageEnhance.Brightness(im).enhance(rng.uniform(1 - brightness, 1 + brightness)),
            lambda im: ImageEnhance.Contrast(im).enhance(rng.uniform(1 - contrast, 1 + contrast)),
            lambda im: ImageEnhance.Color(im).enhance(rng.uniform(1 - saturation, 1 + saturation)),
            lambda im: _hue_shift(im, rng.uniform(-hue, hue)),
        ]
        rng.shuffle(ops)
        for op in ops:
            img = op(img)
    if rng.random() < grayscale_p:
        img = img.convert("L").convert("RGB")
    return img


def _hue_shift(img: Image.Image, factor: float) -> Image.Image:
    if abs(factor) < 1e-6:
        return img
    hsv = np.asarray(img.convert("HSV")).copy()
    hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(factor * 255)) % 256
    return Image.fromarray(hsv, "HSV").convert("RGB")


def train_transform(
    image: np.ndarray,
    crop_size: int,
    rescale_range: Tuple[float, float],
    rng: random.Random,
    fliplr: bool = True,
    ignore_index: int = 255,
    transfer_dtype: str = "float32",
) -> Tuple[np.ndarray, np.ndarray]:
    """The classification-train chain (datasets/voc.py:134-151 + global_view1
    photometric aug).  Returns (image HWC, img_box).

    ``transfer_dtype="float32"``: ImageNet-normalised float32, the reference's
    wire format.  ``"uint8"``: the photometrically-augmented uint8 crop —
    normalisation moves to the device (``ops.image.prepare_inputs``, same float
    ops to <=1 ulp) and the batch crosses host->device at 1/4 the bytes."""
    image = random_scaling(image, scale_range=rescale_range, rng=rng)
    if fliplr:
        image = random_fliplr(image, rng=rng)
    image, img_box = random_crop(
        image, crop_size=crop_size, mean_rgb=(0, 0, 0),
        ignore_index=ignore_index, rng=rng,
    )
    pil = Image.fromarray(image.astype(np.uint8))
    pil = color_jitter(pil, rng=rng)
    pil = gaussian_blur(pil, p=1.0, rng=rng)
    out = np.asarray(pil)
    if transfer_dtype == "uint8":
        return out, img_box
    return normalize_img(out), img_box
