"""In-training validation (counterpart of ``dupl_tpu/engine/validate.py``;
reference: utils/train_helper.py:90-185 ``validate_siamase``).

Every image is resized to the crop square, so images batch together: both
students' cls logits, seg logits and multi-scale CAMs come out of one device
pass; logits and CAMs are bilinear-resized to the label's native size
(matching the reference's interpolate-then-argmax order) and confusion
matrices accumulate on the host.  Reports cls F1, CAM mIoU, aux-CAM mIoU and
seg mIoU per branch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dupl_tpu_torch.ops import cam as cam_ops
from dupl_tpu_torch.ops import image as image_ops
from dupl_tpu_torch.utils import metrics as metrics_utils
from dupl_tpu_torch.utils.metrics import add_hist, resize_logits_host


def cam_label_host(cam: np.ndarray, cls_label: np.ndarray,
                   bkg_thre: float) -> np.ndarray:
    """Static-threshold CAM label on the host (cam_helper.cam_to_label:8-19
    without img_box: argmax + 1, value <= bkg_thre -> 0)."""
    valid = cam * cls_label[None, None, :]
    value = valid.max(-1)
    label = valid.argmax(-1).astype(np.int32) + 1
    label[value <= bkg_thre] = 0
    return label


class Validator:
    """``model``: a ``DualStudent`` holding the weights, on the device the
    validation runs on.

    ``device_post`` (the default) resizes logits and CAMs to the label's
    native size and thresholds / argmaxes on the device, copying only uint8
    label maps to the host.  The device bilinear is
    ``F.interpolate``, the reference's own op; the host path
    (``device_post=False``) goes through PIL, which differs from it in the
    last float bits.

    ``transfer_dtype="bfloat16"`` rounds the full-resolution CAM tensors
    before the host path copies them (CAMs are min-max normalised to [0, 1],
    so the rounding is far below the banding thresholds' margins); under
    ``device_post`` the CAMs never leave the device and the cast is skipped.
    """

    def __init__(self, cfg, model, transfer_dtype: Optional[str] = None,
                 device_post: bool = True):
        self.cfg = cfg
        self.model = model
        self.transfer_dtype = transfer_dtype
        self.device_post = device_post

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _prep(self, image: np.ndarray) -> torch.Tensor:
        """One image in either wire format (uint8 or normalised float32) ->
        (1, crop, crop, 3) normalised, on the device."""
        crop = self.cfg.data.crop_size
        x = torch.tensor(image, device=self.device)  # copies: PIL arrays are read-only
        x, _ = image_ops.prepare_inputs(x[None])
        return image_ops.resize_bilinear(x, (crop, crop))

    def forward(self, x: torch.Tensor):
        """(B, crop, crop, 3) -> (cls (2, B, C_fg), seg (2, B, h, w, C),
        cams (2, B, H, W, C_fg), cams_aux): the scale-1.0 CAM pass shares
        the encoder with the cls/seg forward
        (``Student.forward_with_cams``)."""
        per_branch = []
        for i in range(2):
            s = self.model.student(i)
            cams, cams_aux, out = cam_ops.multi_scale_cam_with_outputs(
                s.forward_with_cams, s.cam_only, x, self.cfg.cam_scales)
            per_branch.append((out.cls, out.seg, cams, cams_aux))
        cls, seg, cams, cams_aux = (torch.stack(t) for t in zip(*per_branch))
        if self.transfer_dtype is not None and not self.device_post:
            dt = getattr(torch, self.transfer_dtype)
            cams, cams_aux = cams.to(dt), cams_aux.to(dt)
        return cls, seg, cams, cams_aux

    def _post(self, seg_i, cams_i, cams_aux_i, cl, size):
        """Device post of one image: seg (2, hs, ws, C), cams (2, H, W,
        C_fg), cl (C_fg,) -> uint8 label maps (3, 2, h, w): seg, CAM, aux
        CAM."""
        bkg = self.cfg.bkg_thre

        def cam_lab(c):
            cu = image_ops.resize_bilinear(c.float(), size, batch_dims=1)
            value, lab = (cu * cl).max(dim=-1)
            return torch.where(value <= bkg, 0, lab + 1)

        seg_lab = image_ops.resize_bilinear(seg_i.float(), size,
                                            batch_dims=1).argmax(dim=-1)
        return torch.stack([seg_lab, cam_lab(cams_i),
                            cam_lab(cams_aux_i)]).to(torch.uint8)

    @torch.inference_mode()
    def run(self, dataset, max_images: Optional[int] = None,
            progress_every: int = 0, log=None,
            batch_size: int = 8) -> Dict[str, object]:
        """Numerically the reference's per-image loop; images are
        micro-batched (each is resized to the same crop square first, so
        batching changes nothing but throughput).  The last chunk is padded
        by repetition, so every device pass has one shape."""
        cfg = self.cfg
        nc = cfg.num_classes
        keys = ("cam_1", "cam_aux_1", "seg_1", "cam_2", "cam_aux_2", "seg_2")
        hists = {k: np.zeros((nc, nc), np.float64) for k in keys}
        f1 = {"1": [], "2": []}

        n = len(dataset) if max_images is None else min(max_images, len(dataset))
        for start in range(0, n, batch_size):
            idxs = list(range(start, min(start + batch_size, n)))
            samples = [dataset[i] for i in idxs]
            imgs = [self._prep(s["image"]) for s in samples]
            imgs += [imgs[-1]] * (batch_size - len(idxs))
            cls_b, seg_b, cams_b, cams_aux_b = self.forward(torch.cat(imgs))
            cls_b = cls_b.float().cpu().numpy()
            if not self.device_post:
                seg_b, cams_b, cams_aux_b = (
                    t.float().cpu().numpy()
                    for t in (seg_b, cams_b, cams_aux_b))

            for j, sample in enumerate(samples):
                label = sample["label"]
                size = label.shape
                cl = sample["cls_label"]
                if self.device_post:
                    seg_lab, cam_lab, aux_lab = self._post(
                        seg_b[:, j], cams_b[:, j], cams_aux_b[:, j],
                        torch.from_numpy(cl).to(self.device), size
                    ).cpu().numpy()
                for k in (0, 1):
                    f1[str(k + 1)].append(metrics_utils.multilabel_f1(
                        cl, (cls_b[k, j] > 0).astype(np.int32)))
                    if self.device_post:
                        labs = seg_lab[k], cam_lab[k], aux_lab[k]
                    else:
                        labs = (
                            resize_logits_host(seg_b[k, j], size).argmax(-1),
                            cam_label_host(resize_logits_host(
                                cams_b[k, j], size), cl, cfg.bkg_thre),
                            cam_label_host(resize_logits_host(
                                cams_aux_b[k, j], size), cl, cfg.bkg_thre))
                    add_hist(hists[f"seg_{k+1}"], label, labs[0])
                    add_hist(hists[f"cam_{k+1}"], label, labs[1])
                    add_hist(hists[f"cam_aux_{k+1}"], label, labs[2])

            done = idxs[-1] + 1
            if progress_every and (done % progress_every < len(idxs)) and log:
                log.info("validate %d/%d", done, n)

        scores = {k: metrics_utils.scores_from_hist(hists[k]) for k in keys}
        result: Dict[str, object] = {f"{k}_miou": scores[k]["miou"] for k in keys}
        result["cls_f1_1"] = float(np.mean(f1["1"])) if f1["1"] else 0.0
        result["cls_f1_2"] = float(np.mean(f1["2"])) if f1["2"] else 0.0
        result["table"] = metrics_utils.format_score_table(
            [scores[k] for k in keys], list(keys), cfg.class_list)
        result["scores"] = scores
        return result
