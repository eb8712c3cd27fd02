"""Strong augmentation on the device (counterpart of
``dupl_tpu/ops/augment.py``).

The reference's strong view (utils/imutils.py:305-317) round-trips every
image through PIL on the host: ``RandAugment(n=5, m=10)`` over a 7-op list
(utils/randomaug.py:161-204: AutoContrast, Equalize, Posterize, Color,
Contrast, Brightness, Sharpness), then a horizontal flip.  Here the same ops
are batched tensor code.  Ops work on [0, 1] float images, scaled to
[0, 255] internally to keep PIL's constants; as in the JAX package, the
uint8 quantisation between chained ops is skipped.

Randomness.  The op indices are an explicit argument, ``ops`` (n, B) int64,
so that a caller (a test, a reproduction) can hand in the draws of any
generator; :func:`draw_ops` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

from dupl_tpu_torch.ops.image import shift_clamped

NUM_OPS = 7
# (min, max) magnitude ranges from randomaug.augment_list:161-204
_RANGES = ((0, 1), (0, 1), (0, 6), (0.1, 1.9), (0.1, 1.9), (0.1, 1.9), (0.1, 1.9))


def _grayscale(img255: torch.Tensor) -> torch.Tensor:
    """PIL "L" weights; (..., 3) -> (...)."""
    return (0.299 * img255[..., 0] + 0.587 * img255[..., 1]
            + 0.114 * img255[..., 2])


def _batched(fn):
    """An op written for (B, H, W, 3), also taking one (H, W, 3) image."""
    def op(img255: torch.Tensor, v=None) -> torch.Tensor:
        if img255.dim() == 3:
            return fn(img255[None], v)[0]
        return fn(img255, v)
    op.__name__, op.__doc__ = fn.__name__, fn.__doc__
    return op


@_batched
def autocontrast(img255, _v):
    """Per-channel linear stretch to [0, 255] (PIL.ImageOps.autocontrast)."""
    lo = img255.amin(dim=(1, 2), keepdim=True)
    hi = img255.amax(dim=(1, 2), keepdim=True)
    out = (img255 - lo) * (255.0 / (hi - lo).clamp_min(1e-5))
    return torch.where(hi > lo, out, img255)


@_batched
def equalize(img255, _v):
    """Per-channel histogram equalisation with PIL's exact LUT rule
    (ImageOps.equalize): step = (total - h[last nonzero]) // 255,
    lut[i] = (step // 2 + cumsum_excl(h)[i]) // step; identity when
    step == 0.  The histogram is a ``scatter_add_`` of integer ones (exact
    in any order) and the LUT is applied with a gather."""
    b, h, w, _ = img255.shape
    n = h * w
    q = img255.clamp(0, 255).long().reshape(b, n, 3).transpose(1, 2)  # (B,3,N)
    hist = torch.zeros(b, 3, 256, dtype=torch.long, device=img255.device)
    hist.scatter_add_(2, q, torch.ones_like(q))
    idx = torch.arange(256, device=img255.device)
    last_nz = torch.where(hist > 0, idx, torch.full_like(idx, -1)).amax(dim=-1)
    h_last = torch.gather(hist, 2, last_nz.clamp_min(0)[..., None])[..., 0]
    step = (hist.sum(dim=-1) - h_last) // 255                        # (B, 3)
    cum_excl = hist.cumsum(dim=-1) - hist
    lut = (step[..., None] // 2 + cum_excl) // step.clamp_min(1)[..., None]
    out = torch.gather(lut.clamp(0, 255), 2, q).to(img255.dtype)
    out = torch.where(step[..., None] > 0, out, q.to(img255.dtype))
    return out.transpose(1, 2).reshape(b, h, w, 3)


@_batched
def posterize(img255, v):
    """Keep the top ``bits`` bits (PIL.ImageOps.posterize); the reference
    maps the magnitude into [0, 6] and clamps bits >= 1
    (randomaug.py:92-95)."""
    step = 2.0 ** (8.0 - max(float(int(v)), 1.0))
    return torch.floor(img255.clamp(0, 255) / step) * step


@_batched
def color(img255, v):
    """Saturation: blend with the per-pixel grayscale (PIL
    ImageEnhance.Color)."""
    gray = _grayscale(img255)[..., None]
    return gray + v * (img255 - gray)


@_batched
def contrast(img255, v):
    """Blend with each image's scalar mean of the grayscale."""
    mean = _grayscale(img255).mean(dim=(1, 2))[:, None, None, None]
    return mean + v * (img255 - mean)


@_batched
def brightness(img255, v):
    return img255 * v


@_batched
def sharpness(img255, v):
    """Blend with PIL's SMOOTH filter (3x3 kernel, centre 5, sum 13); PIL
    leaves the 1-px border of the filtered image untouched.  The kernel is
    (3x3 box + 4 delta) / 13, and the box is nine shifted adds in fp32 (a
    float32 convolution would run in TF32 on the card)."""
    b, h, w, _ = img255.shape
    box = sum(shift_clamped(img255, dy, dx)
              for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    sm = (box + 4.0 * img255) / 13.0
    inner = torch.zeros(1, h, w, 1, dtype=torch.bool, device=img255.device)
    inner[:, 1:h - 1, 1:w - 1] = True
    sm = torch.where(inner, sm, img255)
    return sm + v * (img255 - sm)


OPS = (autocontrast, equalize, posterize, color, contrast, brightness,
       sharpness)


def magnitudes(m: int):
    """The seven ops' magnitudes at RandAugment level ``m`` (of 30)."""
    return tuple((m / 30.0) * (hi - lo) + lo for lo, hi in _RANGES)


def draw_ops(gen: torch.Generator, n: int, batch: int,
             device=None) -> torch.Tensor:
    """(n, B) int64 op indices, uniform over the 7 ops, drawn from ``gen``
    on its own device and moved to ``device``."""
    ops = torch.randint(0, NUM_OPS, (n, batch), generator=gen,
                        device=gen.device)
    return ops.to(device) if device is not None else ops


def rand_augment(images01: torch.Tensor, ops: torch.Tensor,
                 m: int = 10) -> torch.Tensor:
    """Batched RandAugment: image b goes through ops ``ops[0, b]``,
    ``ops[1, b]``, ... in turn, at magnitude ``m``/30
    (randomaug.RandAugment:253-265).  images01 (B, H, W, 3) in [0, 1];
    ops (n, B) integer in [0, 7).  Every round runs all seven ops over the
    whole batch and selects per image, so nothing depends on the indices'
    values on the host.  Returns [0, 1] images."""
    if ops.dim() != 2 or ops.shape[1] != images01.shape[0]:
        raise ValueError(f"rand_augment: ops must be (n, B={images01.shape[0]}"
                         f"), got {tuple(ops.shape)}")
    vals = magnitudes(m)
    img = images01 * 255.0
    for round_ops in ops:
        out = torch.zeros_like(img)
        for i, (op, v) in enumerate(zip(OPS, vals)):
            pick = (round_ops == i)[:, None, None, None]
            out = torch.where(pick, op(img, v).clamp(0.0, 255.0), out)
        img = out
    return img / 255.0


def strong_augment(images01: torch.Tensor, ops: torch.Tensor,
                   m: int = 10) -> torch.Tensor:
    """RandAugment, then a horizontal flip: the strong perturbation of
    ``augment_data_strong`` (imutils.py:305-317).  In and out [0, 1]."""
    return rand_augment(images01, ops, m).flip(2)
