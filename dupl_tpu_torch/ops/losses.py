"""Loss functions (counterpart of ``dupl_tpu/ops/losses.py``; reference:
model/losses.py, train_final_voc.py).  NHWC / (B, H, W, C) layouts, float32,
mask-based: no data-dependent branch and no host sync."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def multilabel_soft_margin_loss(logits: torch.Tensor,
                                targets: torch.Tensor) -> torch.Tensor:
    """``F.multilabel_soft_margin_loss``: per-sample mean over classes of
    -[y log s(x) + (1 - y) log s(-x)], then the mean over the batch."""
    loss = targets * F.softplus(-logits) + (1.0 - targets) * F.softplus(logits)
    return loss.mean(dim=-1).mean()


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


def seg_loss(logits: torch.Tensor, labels: torch.Tensor,
             ignore_index: int = 255) -> torch.Tensor:
    """Background/foreground-balanced CE (reference: model/losses.py:24-39):
    CE averaged separately over background and foreground pixels (each sum
    / (count + 1e-6)), then the two means averaged."""
    ce = cross_entropy_map(logits, labels, ignore_index)
    valid = labels != ignore_index
    bg = valid & (labels == 0)
    fg = valid & (labels != 0)
    zero = torch.zeros_like(ce)
    bg_loss = torch.where(bg, ce, zero).sum() / (bg.sum() + 1e-6)
    fg_loss = torch.where(fg, ce, zero).sum() / (fg.sum() + 1e-6)
    return 0.5 * (bg_loss + fg_loss)


def masked_ptc_loss(fmap: torch.Tensor, aff_mask: torch.Tensor) -> torch.Tensor:
    """Pixel-token-contrast loss (reference: model/losses.py:6-21).  fmap
    (B, H, W, C); aff_mask (B, HW, HW) integer with 1 positive pair, 0
    negative pair, 255 ignore.  The |cosine| Gram matrix of the
    L2-normalised pixel features is pulled to 1 on positive pairs and to 0
    on negative pairs; one batched fp32 product."""
    b, h, w, c = fmap.shape
    x = fmap.reshape(b, h * w, c).float()
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-8)
    gram = torch.matmul(x, x.transpose(1, 2)).abs()
    pos = (aff_mask == 1).float()
    neg = (aff_mask == 0).float()
    pos_term = (pos * gram).sum() / (pos.sum() + 1.0)
    neg_term = (neg * gram).sum() / (neg.sum() + 1.0)
    return 0.5 * (1.0 - pos_term) + 0.5 * neg_term


def discrepancy_loss(fmap_a: torch.Tensor, fmap_b: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """One direction of the dual-student discrepancy loss
    (train_final_voc.py:438-447): ``1 + mean cos(detach(a), b)`` with the
    cosine over the flattened spatial axis per (sample, channel)."""
    b, h, w, c = fmap_a.shape
    a = fmap_a.detach().reshape(b, h * w, c).float()
    bb = fmap_b.reshape(b, h * w, c).float()
    num = (a * bb).sum(dim=1)
    # torch CosineSimilarity(dim, eps): denom = max(|a| * |b|, eps)
    denom = (torch.linalg.vector_norm(a, dim=1)
             * torch.linalg.vector_norm(bb, dim=1)).clamp_min(eps)
    return 1.0 + (num / denom).mean()
