"""The serving program (counterpart of
``dupl_tpu/engine/export.py:make_serving_fn``)."""

from __future__ import annotations

from typing import Sequence

import torch

from dupl_tpu_torch.engine.eval_seg import msc_seg_logits
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.ops import crf as crf_ops
from dupl_tpu_torch.ops import image as image_ops


def make_serving_fn(cfg, model: DualStudent, *,
                    scales: Sequence[float] = (1.0, 1.5, 1.25),
                    merge: str = "max",
                    branch: "int | str" = "ensemble",
                    crf: bool = True):
    """uint8 (B, H, W, 3) image batch on the model's device -> uint8
    (B, H, W) label map.

    Multi-scale + flip seg logits, flip-sum, scale merge, then one student's
    logits (``branch`` in {1, 2}; only that student runs) or the mean of
    both, softmax, the fast mean-field CRF, argmax."""
    if branch not in (1, 2, "ensemble"):
        raise ValueError(f"branch must be 1, 2 or 'ensemble', got {branch!r}")

    if branch == "ensemble":
        def seg_fn(both):
            return model(both).seg                    # (2, B, h, w, C)
    else:
        student = model.student(branch - 1)

        def seg_fn(both):
            return student(both).seg[None]            # (1, B, h, w, C)

    @torch.inference_mode()
    def fn(images: torch.Tensor) -> torch.Tensor:
        x, image01 = image_ops.prepare_inputs(images)
        seg = msc_seg_logits(seg_fn, x, x.shape[1:3], tuple(scales), merge,
                             batch_dims=2)
        pick = seg.mean(dim=0) if branch == "ensemble" else seg[0]
        if crf:
            probs = torch.softmax(pick, dim=-1)
            pick = crf_ops.crf_from_config(image01, probs, cfg.crf,
                                           fast=True, return_logits=True)
        return pick.argmax(dim=-1).to(torch.uint8)

    return fn
