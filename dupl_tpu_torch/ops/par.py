"""PAR, pixel-adaptive refinement (counterpart of ``dupl_tpu/ops/par.py``;
reference: model/PAR.py).

For each pixel, 8 neighbours at each of six dilations (48 taps, replicate
padding).  RGB affinity ``softmax_k(-(|drgb| / std / w1)^2)`` (channel mean)
plus ``w2`` times a constant position affinity, then ``num_iter`` rounds of
``mask <- sum_k neighbour_k(mask) * aff_k``.

:func:`rgb_affinity` and :func:`propagate` are the counterparts of the JAX
package's XLA path, on its taps-last layout: thin wrappers over the kernels'
plain twins.  :func:`par_refine` is what the pipelines call: it
runs the kernel route of ``ops/par_cuda.py`` (K3 affinity, then K4
propagation) on CUDA tensors and the kernels' plain twins on CPU tensors,
with the semantics of the reference's Pallas branch: affinity in fp32,
propagation in ``compute_dtype``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

# 8-connected neighbourhood; diagonal taps are at distance sqrt(2)*d.
OFFSETS: Tuple[Tuple[int, int], ...] = (
    (-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1),
)
DILATIONS = (1, 2, 4, 8, 12, 24)


def tap_offsets(dilations: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """(dy, dx) of every tap, dilation-major, in ``OFFSETS`` order."""
    return tuple((dy * d, dx * d) for d in dilations for dy, dx in OFFSETS)


def position_affinity(dilations: Sequence[int], w1: float = 0.3,
                      w2: float = 0.01) -> Tuple[float, ...]:
    """``w2 * softmax(-(dist / (std + 1e-8) / w1)^2)`` over the taps'
    distances (sqrt(2)*d on diagonals, d on axes; unbiased std), computed in
    float64 on the host (reference: model/PAR.py:51-62,82-85).  Input
    independent: one constant per tap."""
    dist = [math.sqrt(2.0) * d if dy and dx else float(d)
            for d in dilations for dy, dx in OFFSETS]
    n = len(dist)
    mu = sum(dist) / n
    sd = math.sqrt(sum((v - mu) ** 2 for v in dist) / (n - 1))
    logits = [-((v / (sd + 1e-8) / w1) ** 2) for v in dist]
    mx = max(logits)
    es = [math.exp(v - mx) for v in logits]
    tot = sum(es)
    return tuple(w2 * v / tot for v in es)


def rgb_affinity(imgs: torch.Tensor,
                 dilations: Sequence[int] = DILATIONS,
                 w1: float = 0.3, w2: float = 0.01) -> torch.Tensor:
    """Per-pixel 48-tap affinity (reference: model/PAR.py:69-85).

    imgs: (B, H, W, 3) in [0, 1] -> (B, H, W, K) float32, rows summing to
    1 + w2: K3's plain twin on the taps-last layout."""
    from dupl_tpu_torch.ops import par_cuda

    return par_cuda.affinity_ref(imgs, dilations, w1, w2).permute(0, 2, 3, 1)


def propagate(masks: torch.Tensor, aff: torch.Tensor,
              dilations: Sequence[int], num_iter: int) -> torch.Tensor:
    """``num_iter`` rounds of mask <- sum_k neighbour_k(mask) * aff_k
    (reference: model/PAR.py:87-89), fp32.  masks (B, H, W, C), aff
    (B, H, W, K): K4's plain twin on the taps-last layout."""
    from dupl_tpu_torch.ops import par_cuda

    return par_cuda.propagate_ref(masks, aff.permute(0, 3, 1, 2), dilations,
                                  num_iter)


def par_refine(imgs: torch.Tensor, masks: torch.Tensor,
               dilations: Sequence[int] = DILATIONS, num_iter: int = 10,
               w1: float = 0.3, w2: float = 0.01,
               compute_dtype: str = "float32") -> torch.Tensor:
    """Full PAR forward: affinity from ``imgs`` (B, H, W, 3), then
    ``num_iter`` propagation steps on ``masks`` (B, H, W, C) at the same
    spatial size -> (B, H, W, C) float32.  CUDA tensors run kernels K3 and
    K4, CPU tensors their plain twins."""
    from dupl_tpu_torch.ops import par_cuda

    aff = par_cuda.affinity(imgs, dilations, w1, w2)          # (B, K, H, W)
    return par_cuda.propagate(masks.float(), aff, dilations, num_iter,
                              compute_dtype)
