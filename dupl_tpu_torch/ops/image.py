"""Image-space primitives (counterpart of ``dupl_tpu/ops/image.py``).

Public functions take and return NHWC tensors like the reference; they
permute to NCHW internally where torch's operators want it.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# ImageNet statistics in [0,255] units (reference: datasets/transforms.py:45).
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


# Constants are copied to a device once and kept: a copy from the host waits
# for all work queued on the device, so it must not happen on every call.
# They are made outside inference mode, so that recorded ops may use them.
@functools.lru_cache(maxsize=None)
def _imagenet_stats(dtype: torch.dtype, device: torch.device):
    with torch.inference_mode(False):
        return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
                torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def _spatial_apply(x: torch.Tensor, batch_dims: int, fn) -> torch.Tensor:
    """Run ``fn`` on an NCHW view of ``x``: the ``batch_dims`` leading axes
    fold into N and the axes after the two spatial ones into C."""
    lead = x.shape[:batch_dims]
    h, w = x.shape[batch_dims:batch_dims + 2]
    trail = x.shape[batch_dims + 2:]
    nchw = x.reshape(-1, h, w, trail.numel()).permute(0, 3, 1, 2)
    y = fn(nchw)
    return y.permute(0, 2, 3, 1).reshape(*lead, y.shape[2], y.shape[3], *trail)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int], *,
                    batch_dims: int = 1) -> torch.Tensor:
    """Bilinear resize with half-pixel centers and no antialiasing over the
    two dims after ``batch_dims`` (``F.interpolate(mode='bilinear',
    align_corners=False)``, which the reference's jax resize was written to
    match; antialias on downscale would shift a 0.5x resize by ~0.2)."""
    return _spatial_apply(x, batch_dims, lambda t: F.interpolate(
        t, size=tuple(size), mode="bilinear", align_corners=False,
        antialias=False))


def resize_nearest(x: torch.Tensor, size: Tuple[int, int], *,
                   batch_dims: int = 1) -> torch.Tensor:
    """Nearest resize with half-pixel source indices
    ``floor((i + 0.5) * in / out)`` computed in float32, as
    ``jax.image.resize(method='nearest')`` does."""
    out = x
    for axis, n in zip((batch_dims, batch_dims + 1), size):
        m = out.shape[axis]
        src = (torch.arange(n, dtype=torch.float32, device=x.device)
               + 0.5) * m / n
        idx = torch.floor(src).long().clamp_(max=m - 1)
        out = out.index_select(axis, idx)
    return out


def _cubic_kernel(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Cubic convolution kernel with torch's A = -0.75."""
    at = t.abs()
    near = ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0
    far = a * (((at - 5.0) * at + 8.0) * at - 4.0)
    return torch.where(at <= 1.0, near,
                       torch.where(at < 2.0, far, torch.zeros_like(at)))


def _bicubic_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(out, in) sampling matrix for 1-D torch-style bicubic: half-pixel
    centers, 4 taps, indices clamped to the border (replicate)."""
    scale = in_size / out_size
    src = (torch.arange(out_size, dtype=torch.float32) + 0.5) * scale - 0.5
    i0 = torch.floor(src).long()
    w = torch.zeros(out_size, in_size, dtype=torch.float32)
    rows = torch.arange(out_size)
    for k in range(-1, 3):
        idx = (i0 + k).clamp(0, in_size - 1)
        w.index_put_((rows, idx), _cubic_kernel(src - (i0 + k).float()),
                     accumulate=True)
    return w


@functools.lru_cache(maxsize=64)
def _bicubic_weights_on(in_size: int, out_size: int, dtype: torch.dtype,
                        device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return _bicubic_weights(in_size, out_size).to(device, dtype)


def resize_bicubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bicubic resize matching ``F.interpolate(mode='bicubic',
    align_corners=False)`` (A = -0.75, no antialias, border-clamped taps) as
    two sampling matrices, the reference's formulation.  x: (B, H, W, C)."""
    wh = _bicubic_weights_on(x.shape[1], size[0], x.dtype, x.device)
    ww = _bicubic_weights_on(x.shape[2], size[1], x.dtype, x.device)
    return torch.einsum("oh,bhwc,pw->bopc", wh, x, ww)


def denormalize(x: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalised float image -> [0,1] floats."""
    mean, std = _imagenet_stats(x.dtype, x.device)
    return (x * std + mean) / 255.0


def normalize(x01: torch.Tensor) -> torch.Tensor:
    """[0,1] floats -> ImageNet-normalised."""
    mean, std = _imagenet_stats(x01.dtype, x01.device)
    return (x01 * 255.0 - mean) / std


def prepare_inputs(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [0,255] or ImageNet-normalised float32 batch ->
    ``(imagenet_normalised_f32, denormalised_01)``."""
    if image.dtype == torch.uint8:
        f = image.float()
        mean, std = _imagenet_stats(torch.float32, image.device)
        return (f - mean) / std, f / 255.0
    return image, denormalize(image)


def box_mask(img_box: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, 4) [h0, h1, w0, w1] -> (B, H, W) bool mask of the valid crop
    region (reference: utils/cam_helper.py:26-28)."""
    rows = torch.arange(height, device=img_box.device)[None, :, None]
    cols = torch.arange(width, device=img_box.device)[None, None, :]
    h0, h1, w0, w1 = (img_box[:, i, None, None] for i in range(4))
    return (rows >= h0) & (rows < h1) & (cols >= w0) & (cols < w1)


def scale_box(img_box: torch.Tensor, factor_num: int,
              factor_den: int) -> torch.Tensor:
    """Rescale integer box coordinates by factor_num/factor_den (floor)."""
    return img_box * factor_num // factor_den


def spatial_minmax_norm(cam: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, class) spatial min-max normalisation over the two axes
    before the channel axis (reference: utils/cam_helper.py:196-202).
    cam: (..., H, W, C)."""
    cam = cam - cam.amin(dim=(-3, -2), keepdim=True)
    return cam / (cam.amax(dim=(-3, -2), keepdim=True) + eps)


def shift_clamped(x: torch.Tensor, dy: int, dx: int,
                  axis: int = 1) -> torch.Tensor:
    """``out[.., y, x, ..] = x[.., clamp(y + dy), clamp(x + dx), ..]`` over
    the row axis ``axis`` and the column axis after it: the tap of a
    replicate-padded image, for any offset size."""
    h, w = x.shape[axis], x.shape[axis + 1]
    rows = (torch.arange(h, device=x.device) + dy).clamp_(0, h - 1)
    cols = (torch.arange(w, device=x.device) + dx).clamp_(0, w - 1)
    return x.index_select(axis, rows).index_select(axis + 1, cols)


def dilated_neighbors(x: torch.Tensor, dilations: Sequence[int]) -> torch.Tensor:
    """The 8-connected neighbourhood at each dilation with replicate padding
    (reference: model/PAR.py:39-49).  x: (B, H, W, C) -> (B, H, W, K, C),
    K = 8 * len(dilations), taps dilation-major in ``ops.par.OFFSETS``
    order."""
    from dupl_tpu_torch.ops.par import OFFSETS

    return torch.stack([shift_clamped(x, dy * d, dx * d)
                        for d in dilations for dy, dx in OFFSETS], dim=3)
