"""The serving program and the pseudo-label factory (counterparts of
``dupl_tpu/engine/export.py:make_serving_fn`` and ``make_pseudo_label_fn``)."""

from __future__ import annotations

from typing import Sequence

import torch

from dupl_tpu_torch.engine.eval_seg import msc_seg_logits
from dupl_tpu_torch.engine.train import refine
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.ops import cam as cam_ops
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


def make_pseudo_label_fn(cfg, model: DualStudent):
    """The pseudo-label factory (counterpart of
    ``dupl_tpu/engine/export.py:make_pseudo_label_fn``): multi-scale + flip
    CAMs of both students at ``cfg.cam_scales``, merged at half the input
    size; PAR refinement of both into per-branch pseudo-labels; the fast
    mean-field CRF over student 1's segmentation posteriors.

    ``fn(images, cls_label, img_box)`` takes uint8 (B, H, W, 3) images,
    (B, C_fg) multi-hot class labels and (B, 4) int boxes on the model's
    device and returns ``(refined, crf_labels)``: uint8 (2, B, H, W)
    pseudo-labels (``cfg.ignore_index`` marks the ignore band) and uint8
    (B, H, W) CRF labels, both at the input resolution."""

    @torch.inference_mode()
    def fn(images: torch.Tensor, cls_label: torch.Tensor,
           img_box: torch.Tensor):
        # the class-budget branch is chosen on the host before this call
        # queues anything, so reading cls_label does not wait for the CAMs
        fits = cam_ops.fits_class_budget(cls_label, cfg.par.class_budget)
        x, image01 = image_ops.prepare_inputs(images)
        merge = (x.shape[1] // 2, x.shape[2] // 2)
        cams, segs = [], []
        for i in range(2):              # the JAX package vmaps the branches
            s = model.student(i)
            cam, _, out = cam_ops.multi_scale_cam_with_outputs(
                s.forward_with_cams, s.cam_only, x, cfg.cam_scales,
                with_aux=False, merge_size=merge)
            cams.append(cam)
            segs.append(out.seg)
        refined = refine(cfg, torch.stack(cams), image01, cls_label, img_box,
                         high_thre=cfg.high_thre, fits_budget=fits)
        seg = image_ops.resize_bilinear(segs[0], x.shape[1:3])
        logits = crf_ops.crf_from_config(image01, torch.softmax(seg, dim=-1),
                                         cfg.crf, fast=True,
                                         return_logits=True)
        return refined.to(torch.uint8), logits.argmax(dim=-1).to(torch.uint8)

    return fn
