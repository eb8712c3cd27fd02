"""Learning-rate and threshold schedules (counterpart of
``dupl_tpu/ops/schedule.py``)."""

from __future__ import annotations

import math

import torch


def poly_warmup_schedule(step: int, *, base_lr: float, warmup_iters: int,
                         warmup_ratio: float, max_iters: int,
                         power: float) -> float:
    """PolyWarmupAdamW LR rule (reference: utils/optimizer.py:51-68): linear
    warm-up of the multiplier from ``warmup_ratio`` to 1 over
    ``warmup_iters`` steps, then ``(1 - step/max_iters) ** power`` decay, 0
    from ``max_iters`` on.  ``step`` counts completed optimizer steps from
    0 and is known on the host, so this is plain Python arithmetic."""
    if step >= max_iters:
        return 0.0
    if step < warmup_iters:
        # algebraically 1 - (1 - t)(1 - r); this form avoids cancellation
        mult = warmup_ratio + (step / warmup_iters) * (1.0 - warmup_ratio)
    else:
        mult = (1.0 - step / max_iters) ** power
    return base_lr * mult


def cosine_descent(max_thres: torch.Tensor, min_thres: torch.Tensor,
                   step: int, num_steps: int) -> torch.Tensor:
    """Cosine interpolation from ``max_thres`` to ``min_thres`` over
    ``num_steps`` (reference: utils/train_helper.py:340-349; note the
    ``(num_steps - 1)`` denominator).  Tensors in, float32 tensor out on
    their device; ``step`` is the host's integer, and the weight is computed
    on the host, so nothing crosses to the device and nothing waits for it."""
    max_thres = max_thres.float()
    min_thres = min_thres.float()
    if step < 0:
        return max_thres.clone()
    if step >= num_steps:
        return min_thres.clone()
    # float32 arithmetic throughout, as the reference's traced form
    t = torch.tensor(step, dtype=torch.float32) / (num_steps - 1)
    w = ((1.0 - torch.cos(math.pi * t)) / 2.0).item()
    return max_thres + (min_thres - max_thres) * w


def per_sample_high_thre(high_thres: torch.Tensor,
                         cls_label: torch.Tensor) -> torch.Tensor:
    """Per-sample dynamic high threshold: the max of the per-class scheduled
    thresholds over the classes present in the image (reference:
    train_final_voc.py:269-275).  (C,), (B, C) -> (B,)."""
    neg_inf = torch.full_like(high_thres, -float("inf"))
    return torch.where(cls_label > 0, high_thres[None, :], neg_inf[None, :]
                       ).amax(dim=-1)
