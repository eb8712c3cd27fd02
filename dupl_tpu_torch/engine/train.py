"""The training engine's pseudo-label refinement (counterpart of
``dupl_tpu/engine/train.py``: ``Trainer._par_fn`` and ``Trainer._refine``).

The rest of the trainer is not ported yet; these two functions are what the
pseudo-label factory and the future trainer share.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from dupl_tpu_torch.ops import cam as cam_ops
from dupl_tpu_torch.ops import par as par_ops


def par_fn(cfg, imgs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """PAR with the recipe's ``cfg.par`` settings: (B, H, W, 3) images and
    (B, H, W, C) masks -> refined (B, H, W, C) float32."""
    p = cfg.par
    return par_ops.par_refine(imgs, masks, dilations=tuple(p.dilations),
                              num_iter=p.num_iter, w1=p.w1, w2=p.w2,
                              compute_dtype=p.compute_dtype)


def refine(cfg, cams: torch.Tensor, image01: torch.Tensor,
           cls_label: torch.Tensor, img_box, high_thre,
           fits_budget: Optional[bool] = None) -> torch.Tensor:
    """PAR-refined pseudo-labels per branch: cams (2, B, h, w, C_fg) ->
    labels (2, B, H, W).  Both students' CAMs, with both background planes,
    ride one PAR call, so the image-only affinity is computed once per
    image.  ``fits_budget``: ``cam_ops.fits_class_budget`` of ``cls_label``
    and ``cfg.par.class_budget``, taken before the CAMs were queued (None
    takes it here)."""
    valid = cams * cls_label[None, :, None, None, :]
    return cam_ops.refine_cams_with_bkg(
        functools.partial(par_fn, cfg), image01, valid, cls_label,
        high_thre=high_thre, low_thre=cfg.low_thre, img_box=img_box,
        ignore_index=cfg.ignore_index, down_scale=cfg.par.down_scale,
        class_budget=cfg.par.class_budget, fits_budget=fits_budget)
