"""Loss functions (counterpart of ``dupl_tpu/ops/losses.py``; reference:
model/losses.py, train_final_voc.py).  NHWC / (B, H, W, C) layouts, float32,
mask-based: no data-dependent branch and no host sync.

Each loss normalises by its own batch unless told otherwise.  A
data-parallel rank holds a slice of the global batch and passes the global
normalisers (``batch``: the global batch size; ``counts``: the global batch's
pixel or pair counts, from :func:`seg_counts` and :func:`ptc_counts` summed
over the ranks; ``unit``: its part of the loss's constant), so that the
ranks' losses sum to the loss of the global batch, and their summed
gradients to its gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def multilabel_soft_margin_loss(logits: torch.Tensor, targets: torch.Tensor,
                                batch: Optional[int] = None) -> torch.Tensor:
    """``F.multilabel_soft_margin_loss``: per-sample mean over classes of
    -[y log s(x) + (1 - y) log s(-x)], then the mean over the batch (the
    sum over these samples / ``batch`` when given)."""
    loss = targets * F.softplus(-logits) + (1.0 - targets) * F.softplus(logits)
    if batch is None:
        return loss.mean(dim=-1).mean()
    return loss.mean(dim=-1).sum() / batch


def cross_entropy_map(logits: torch.Tensor, labels: torch.Tensor,
                      ignore_index: int = 255) -> torch.Tensor:
    """Per-pixel CE with the ignore semantics of ``nn.CrossEntropyLoss(
    reduction='none')``: ignored pixels contribute exactly 0.  logits
    (..., C), labels (...) integer -> (...) float32.  Streaming form:
    logsumexp minus the picked logit, so no normalised (..., C) map is
    written."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    x = logits.float()
    picked = torch.gather(x, -1, safe[..., None])[..., 0]
    ce = torch.logsumexp(x, dim=-1) - picked
    return torch.where(valid, ce, torch.zeros_like(ce))


def _bg_fg(labels: torch.Tensor, ignore_index: int):
    valid = labels != ignore_index
    return valid & (labels == 0), valid & (labels != 0)


def seg_counts(labels: torch.Tensor, ignore_index: int = 255
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`seg_loss`'s normalisers: the background and foreground pixel
    counts of ``labels``."""
    bg, fg = _bg_fg(labels, ignore_index)
    return bg.sum(), fg.sum()


def seg_loss(logits: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = 255, counts=None) -> torch.Tensor:
    """Background/foreground-balanced CE (reference: model/losses.py:24-39):
    CE averaged separately over background and foreground pixels (each sum
    / (count + 1e-6)), then the two means averaged.  ``counts``: the (bg,
    fg) counts to divide by, default :func:`seg_counts` of ``labels``."""
    ce = cross_entropy_map(logits, labels, ignore_index)
    bg, fg = _bg_fg(labels, ignore_index)
    bg_n, fg_n = (bg.sum(), fg.sum()) if counts is None else counts
    zero = torch.zeros_like(ce)
    bg_loss = torch.where(bg, ce, zero).sum() / (bg_n + 1e-6)
    fg_loss = torch.where(fg, ce, zero).sum() / (fg_n + 1e-6)
    return 0.5 * (bg_loss + fg_loss)


def ptc_counts(aff_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`masked_ptc_loss`'s normalisers: the positive and negative pair
    counts of ``aff_mask`` (float32, as the loss sums them)."""
    return (aff_mask == 1).float().sum(), (aff_mask == 0).float().sum()


def masked_ptc_loss(fmap: torch.Tensor, aff_mask: torch.Tensor, counts=None,
                    unit: float = 1.0) -> torch.Tensor:
    """Pixel-token-contrast loss (reference: model/losses.py:6-21).  fmap
    (B, H, W, C); aff_mask (B, HW, HW) integer with 1 positive pair, 0
    negative pair, 255 ignore.  The |cosine| Gram matrix of the
    L2-normalised pixel features is pulled to 1 on positive pairs and to 0
    on negative pairs; one batched fp32 product.  ``counts``: the (positive,
    negative) pair counts to divide by, default :func:`ptc_counts` of
    ``aff_mask``; ``unit``: the constant 1 of the positive term."""
    b, h, w, c = fmap.shape
    x = fmap.reshape(b, h * w, c).float()
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-8)
    gram = torch.matmul(x, x.transpose(1, 2)).abs()
    pos = (aff_mask == 1).float()
    neg = (aff_mask == 0).float()
    pos_n, neg_n = (pos.sum(), neg.sum()) if counts is None else counts
    pos_term = (pos * gram).sum() / (pos_n + 1.0)
    neg_term = (neg * gram).sum() / (neg_n + 1.0)
    return 0.5 * (unit - pos_term) + 0.5 * neg_term


def discrepancy_loss(fmap_a: torch.Tensor, fmap_b: torch.Tensor,
                     eps: float = 1e-6, batch: Optional[int] = None,
                     unit: float = 1.0) -> torch.Tensor:
    """One direction of the dual-student discrepancy loss
    (train_final_voc.py:438-447): ``1 + mean cos(detach(a), b)`` with the
    cosine over the flattened spatial axis per (sample, channel).  With
    ``batch``: ``unit`` + the sum of the cosines / (``batch`` x channels)."""
    b, h, w, c = fmap_a.shape
    a = fmap_a.detach().reshape(b, h * w, c).float()
    bb = fmap_b.reshape(b, h * w, c).float()
    num = (a * bb).sum(dim=1)
    # torch CosineSimilarity(dim, eps): denom = max(|a| * |b|, eps)
    denom = (torch.linalg.vector_norm(a, dim=1)
             * torch.linalg.vector_norm(bb, dim=1)).clamp_min(eps)
    if batch is None:
        return 1.0 + (num / denom).mean()
    return unit + (num / denom).sum() / (batch * c)
