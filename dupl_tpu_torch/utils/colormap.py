"""VOC palette (reference: utils/imutils.py:41-59) and the jet colormap of
the CAM overlays, numpy only (PIL for the palette PNG)."""

from __future__ import annotations

import numpy as np

# The breakpoints (x, y) of matplotlib's "jet" per channel: each channel is
# a clipped linear ramp up and a clipped linear ramp down.
_JET = {
    "red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0),
              (0.91, 0.0), (1.0, 0.0)),
    "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
}


def voc_colormap(n: int = 256) -> np.ndarray:
    """The standard VOC bit-interleaved palette, (N, 3) uint8."""
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def encode_cmap(label: np.ndarray) -> np.ndarray:
    """Class-index map -> RGB image."""
    return voc_colormap()[np.asarray(label, np.int32)]


def save_indexed_png(path: str, label: np.ndarray) -> None:
    """Save a class-index map as a palettised (mode ``P``) PNG with the VOC
    palette, what the official VOC evaluation server expects (reference:
    tools/convert_test_seg.py)."""
    from PIL import Image

    img = Image.fromarray(np.asarray(label, np.uint8), mode="P")
    img.putpalette(voc_colormap().reshape(-1).tolist())
    img.save(path)


def jet(x: np.ndarray) -> np.ndarray:
    """The jet colormap of values in [0, 1] -> (..., 3) floats in [0, 1],
    computed here (no plotting library needed): the piecewise-linear ramps
    sampled into a 256-entry table that ``floor(256 x)`` indexes, as
    ``matplotlib.cm.jet`` does."""
    grid = np.linspace(0.0, 1.0, 256)
    lut = np.stack([np.interp(grid, *zip(*_JET[c]))
                    for c in ("red", "green", "blue")], axis=-1)
    idx = np.clip((np.asarray(x, np.float64) * 256).astype(np.int64), 0, 255)
    return lut[idx]
