"""Segmentation / classification metrics (counterpart of
``dupl_tpu/utils/metrics.py``; reference: utils/evaluate.py).

``fast_hist`` takes tensors and counts on their device (one ``bincount``);
everything else is numpy on the host, where scores are finalised in float64.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def fast_hist(label_true: torch.Tensor, label_pred: torch.Tensor,
              num_classes: int) -> torch.Tensor:
    """Confusion-matrix update (reference: utils/evaluate.py:9-15): rows =
    truth, cols = prediction; pixels with truth outside [0, num_classes) are
    dropped, predictions are clipped into range.  Returns (C, C) int64 on
    the inputs' device."""
    t = label_true.reshape(-1).long()
    p = label_pred.reshape(-1).long()
    mask = (t >= 0) & (t < num_classes)
    idx = torch.where(mask,
                      num_classes * t + p.clamp(0, num_classes - 1),
                      num_classes * num_classes)
    hist = torch.bincount(idx, minlength=num_classes * num_classes + 1)[:-1]
    return hist.reshape(num_classes, num_classes)


def add_hist(hist: np.ndarray, gt: np.ndarray, pred: np.ndarray) -> None:
    """Accumulate a confusion matrix in place (host-side counterpart of
    :func:`fast_hist`; shared by the validator, the offline evaluator and
    tools/infer_cam_torch.py)."""
    nc = hist.shape[0]
    gt = gt.reshape(-1)
    pred = pred.reshape(-1)
    mask = (gt >= 0) & (gt < nc)
    hist += np.bincount(
        nc * gt[mask].astype(np.int64) + pred[mask], minlength=nc * nc
    ).reshape(nc, nc)


def resize_logits_host(logits: np.ndarray, size) -> np.ndarray:
    """(h, w, C) float logits -> bilinear resize to ``size`` on the host, in
    PIL as the reference package does (its F.interpolate-to-native-before-
    argmax protocol step), so the scores of the two packages match there."""
    from PIL import Image

    h, w = size
    out = np.empty((h, w, logits.shape[-1]), np.float32)
    for c in range(logits.shape[-1]):
        out[..., c] = np.asarray(
            Image.fromarray(logits[..., c]).resize((w, h), Image.BILINEAR)
        )
    return out


def scores_from_hist(hist: np.ndarray) -> Dict[str, object]:
    """pAcc / mAcc / mIoU / per-class IoU from an accumulated confusion matrix
    (reference: utils/evaluate.py:17-35; mIoU averages only classes that
    appear in the ground truth)."""
    hist = np.asarray(hist, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
        valid = hist.sum(axis=1) > 0
        mean_iu = np.nanmean(iu[valid]) if valid.any() else float("nan")
    return {
        "pAcc": float(acc),
        "mAcc": float(acc_cls),
        "miou": float(mean_iu),
        "iou": dict(zip(range(hist.shape[0]), iu)),
    }


def scores(label_trues: Sequence[np.ndarray], label_preds: Sequence[np.ndarray],
           num_classes: int = 21) -> Dict[str, object]:
    """Convenience host-side path matching ``evaluate.scores`` exactly."""
    hist = np.zeros((num_classes, num_classes), np.float64)
    for lt, lp in zip(label_trues, label_preds):
        lt = np.asarray(lt).reshape(-1)
        lp = np.asarray(lp).reshape(-1)
        mask = (lt >= 0) & (lt < num_classes)
        hist += np.bincount(
            num_classes * lt[mask].astype(int) + lp[mask].astype(int),
            minlength=num_classes ** 2,
        ).reshape(num_classes, num_classes)
    return scores_from_hist(hist)


def multilabel_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Binary F1 over the flattened multi-hot vector (reference:
    utils/evaluate.py:4-6 uses ``sklearn.metrics.f1_score``)."""
    y_true = np.asarray(y_true).reshape(-1) > 0
    y_pred = np.asarray(y_pred).reshape(-1) > 0
    tp = float(np.sum(y_true & y_pred))
    fp = float(np.sum(~y_true & y_pred))
    fn = float(np.sum(y_true & ~y_pred))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def format_score_table(score_dicts: List[Dict], names: List[str],
                       class_list: Sequence[str]) -> str:
    """Per-class IoU table (reference: utils/pyutils.py:7-27 via texttable)."""
    width = max(len(c) for c in class_list) + 2
    header = "class".ljust(width) + "".join(n.rjust(12) for n in names)
    lines = [header, "-" * len(header)]
    for ci, cname in enumerate(class_list):
        row = cname.ljust(width)
        for s in score_dicts:
            row += f"{100 * s['iou'][ci]:12.3f}"
        lines.append(row)
    lines.append("-" * len(header))
    row = "mIoU".ljust(width)
    for s in score_dicts:
        row += f"{100 * s['miou']:12.3f}"
    lines.append(row)
    return "\n".join(lines)
