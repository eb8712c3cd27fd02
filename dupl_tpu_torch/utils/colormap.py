"""VOC palette (reference: utils/imutils.py:41-59), numpy only."""

from __future__ import annotations

import numpy as np


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
