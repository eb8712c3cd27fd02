"""Multi-scale + flip segmentation logits (counterpart of
``dupl_tpu/engine/eval_seg.py:msc_seg_logits``; reference:
tools/eval_seg_voc.py:56-77 max-merge, eval_seg_coco_ddp.py:120-121
sum-merge)."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from dupl_tpu_torch.ops.image import resize_bilinear


def msc_seg_logits(seg_fn: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor, out_size, scales: Sequence[float],
                   merge: str = "max", batch_dims: int = 1) -> torch.Tensor:
    """``seg_fn`` maps an NHWC batch to (..., B, h, w, C) seg logits; leading
    axes before the batch (the dual-student branch axis) ride along, and
    ``batch_dims`` counts the output's axes up to and including the batch.
    Per scale the batch rides with its horizontal flip; logits are resized
    to ``out_size`` and flip-summed; scales merge by max or sum."""
    b, hh, ww, _ = x.shape
    merged = None
    for sc in scales:
        size = (int(hh * sc), int(ww * sc))
        xs = x if sc == 1.0 else resize_bilinear(x, size)
        both = torch.cat([xs, xs.flip(2)], dim=0)
        seg = resize_bilinear(seg_fn(both), tuple(out_size),
                              batch_dims=batch_dims)
        seg = seg[..., :b, :, :, :] + seg[..., b:, :, :, :].flip(-2)
        if merged is None:
            merged = seg
        elif merge == "max":
            merged = torch.maximum(merged, seg)
        else:
            merged = merged + seg
    return merged
