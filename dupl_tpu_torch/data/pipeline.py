"""Synthetic training batches (counterpart of
``dupl_tpu/data/pipeline.py:synthetic_batch``; numpy only).

The dataset readers and the device feeder are not ported yet; the trainer's
tests, benchmark and smoke run train on these batches.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_batch(batch: int, crop: int = 448, num_fg: int = 20,
                    seed: int = 0, style: str = "blob") -> Dict[str, np.ndarray]:
    """Deterministic fake train batch: piecewise-constant colour blobs (so
    PAR and CRF affinities are non-trivial) plus multi-hot labels.  Returns
    ``image`` (B, crop, crop, 3) float32 ImageNet-normalised, ``cls_label``
    (B, num_fg) float32 with about three present classes an image whatever
    the class-list width, and ``img_box`` (B, 4) int32 [h0, h1, w0, w1].
    The same seed gives the same arrays as the JAX package's function."""
    if style != "blob":
        raise NotImplementedError(
            f"synthetic_batch style {style!r}: only 'blob' is ported (the "
            f"'photo' scenes belong to the data pipeline)")
    rs = np.random.RandomState(seed)
    blocks = rs.rand(batch, 8, 8, 3).astype(np.float32)
    image01 = np.kron(blocks, np.ones((1, crop // 8, crop // 8, 1), np.float32))
    image01 += rs.rand(batch, crop, crop, 3).astype(np.float32) * 0.05
    image01 = np.clip(image01, 0, 1)
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    image = (image01 - mean) / std
    cls_label = (rs.rand(batch, num_fg) > 1.0 - 3.0 / num_fg).astype(np.float32)
    cls_label[np.arange(batch), rs.randint(0, num_fg, batch)] = 1
    img_box = np.tile(np.asarray([[16, crop - 16, 8, crop - 8]], np.int32),
                      (batch, 1))
    return {"image": image, "cls_label": cls_label, "img_box": img_box}
