"""TensorBoard output of the training run (counterpart of
``dupl_tpu/utils/tb.py``; reference: the tensorboardX calls of
train_final_voc.py:113,493-508: loss scalars, validation scores, jet CAM
overlay grids).

:class:`TbWriter` uses whichever ``SummaryWriter`` imports
(``torch.utils.tensorboard``, which needs the ``tensorboard`` package, then
``tensorboardX``) and is a no-op when neither does, so a training run never
depends on one.  A backend is imported only when a writer is built.
:func:`cam_grids` is the extra no-grad CAM pass whose grids the run writes
at its log boundaries; it is a plain function of a ``Trainer`` and a batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dupl_tpu_torch.ops import image as image_ops
from dupl_tpu_torch.utils.colormap import jet


class TbWriter:
    """Scalars and HWC images into ``log_dir``; ``log_dir=None`` (a rank
    that is not the main one) or no importable backend: a no-op."""

    def __init__(self, log_dir: Optional[str]):
        self._w = None
        if log_dir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
        self._w = SummaryWriter(log_dir=log_dir)

    @property
    def enabled(self) -> bool:
        return self._w is not None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        if self._w is not None:
            self._w.add_image(tag, np.asarray(img_hwc), step,
                              dataformats="HWC")

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None


def _tile(images: np.ndarray, nrow: int) -> np.ndarray:
    """(B, H, W, 3) -> one float32 grid of ``nrow`` columns, zeros where a
    row is short."""
    b, h, w, _ = images.shape
    rows = -(-b // nrow)
    grid = np.zeros((rows * h, nrow * w, 3), np.float32)
    for i in range(b):
        r, c = divmod(i, nrow)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = images[i]
    return grid


def image_grid(images01: np.ndarray, nrow: int = 2) -> np.ndarray:
    """(B, H, W, 3) in [0, 1] -> one uint8 grid image (the reference's
    "CAM/inputs" panel, imutils.py:255-257)."""
    return (np.clip(_tile(images01, nrow), 0, 1) * 255).astype(np.uint8)


def cam_overlay_grid(images01: np.ndarray, cams: np.ndarray,
                     nrow: int = 2) -> np.ndarray:
    """Jet CAM overlay grid (reference: utils/imutils.py:255-267).

    images01: (B, H, W, 3) in [0, 1]; cams: (B, h, w, C).  CAMs coarser than
    the images (merged at input / ``cam_merge_downscale``) are
    nearest-upsampled to the image grid; the per-pixel maximum over classes,
    clipped to [0, 1], is colormapped and blended 50/50 with the image in
    [0, 1] before the scale to 255."""
    _, h, w, _ = images01.shape
    ch, cw = cams.shape[1:3]
    if (ch, cw) != (h, w):
        iy = (np.arange(h) * ch) // h
        ix = (np.arange(w) * cw) // w
        cams = cams[:, iy][:, :, ix]
    heat = jet(np.clip(cams.max(-1), 0, 1))
    return (_tile(0.5 * heat + 0.5 * images01, nrow) * 255).astype(np.uint8)


@torch.no_grad()
def cam_grids(trainer, images: torch.Tensor, cls_label,
              n: int = 4) -> Dict[str, np.ndarray]:
    """The CAM grids of the first ``n`` samples of a training batch
    (counterpart of tools/train.py:299-311): the inputs, then each
    student's multi-scale CAMs (``Trainer._multi_scale_cams``, one no-grad
    pass on the batch's device) masked by the image-level labels and
    overlaid.  images: the (B, H, W, 3) batch in either wire format;
    cls_label: (B, C_fg) -> ``{"CAM/inputs", "CAM/cams_1", "CAM/cams_2"}``,
    each a uint8 HWC grid."""
    n = min(n, images.shape[0])
    norm, images01 = image_ops.prepare_inputs(images[:n])
    cams = trainer._multi_scale_cams(norm)[0].float().cpu().numpy()
    labels = torch.as_tensor(cls_label)[:n].cpu().numpy().astype(np.float32)
    cams = cams * labels[None, :, None, None, :]
    images01 = images01.float().cpu().numpy()
    return {"CAM/inputs": image_grid(images01),
            "CAM/cams_1": cam_overlay_grid(images01, cams[0]),
            "CAM/cams_2": cam_overlay_grid(images01, cams[1])}
