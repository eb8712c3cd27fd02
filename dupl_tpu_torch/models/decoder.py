"""Segmentation decoders (counterpart of ``dupl_tpu/models/decoder.py``;
reference: model/decoder/conv_head.py): ``LargeFOV``, the recipes'
decoder, and ``ASPP``, part of the reference's API and wired into no
recipe."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dupl_tpu_torch.parallel import tensor_parallel


class LargeFOV(nn.Module):
    """3x3 dilated conv -> ReLU -> 3x3 dilated conv -> ReLU -> 1x1 conv to
    classes, all bias-free (reference: model/decoder/conv_head.py:11-41).
    NHWC in, float32 NHWC out; the convs run in ``compute_dtype``.  A conv
    given ``tp`` and ``tp_role`` (``parallel/tensor_parallel.py``: conv6
    column-, conv7 row-parallel) runs on this rank's share, conv7's product
    summed over the model group before its ReLU."""

    def __init__(self, in_planes: int, out_planes: int, embed_dim: int = 512,
                 dilation: int = 5, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        d = dilation
        self.conv6 = nn.Conv2d(in_planes, embed_dim, 3, padding=d, dilation=d,
                               bias=False)
        self.conv7 = nn.Conv2d(embed_dim, embed_dim, 3, padding=d, dilation=d,
                               bias=False)
        self.conv8 = nn.Conv2d(embed_dim, out_planes, 1, bias=False)
        self.compute_dtype = compute_dtype

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        tp = getattr(conv, "tp", None)
        if tp is not None:
            return tensor_parallel.parallel_conv(x, conv.weight.to(cd), conv,
                                                 tp, conv.tp_role)
        return F.conv2d(x.to(cd), conv.weight.to(cd), padding=conv.padding,
                        dilation=conv.dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self._conv(self.conv6, x))
        x = F.relu(self._conv(self.conv7, x))
        x = self._conv(self.conv8, x)
        return x.permute(0, 2, 3, 1).float()


class ASPP(nn.Module):
    """The sum of parallel biased 3x3 atrous convs ``c0``, ``c1``, ...,
    one a rate (reference: conv_head.py:43-58).  NHWC in, float32 NHWC out;
    the convs and their sum run in ``compute_dtype``."""

    def __init__(self, in_planes: int, out_planes: int,
                 atrous_rates: Sequence[int] = (6, 12, 18, 24),
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for i, rate in enumerate(atrous_rates):
            self.add_module(f"c{i}", nn.Conv2d(in_planes, out_planes, 3,
                                               padding=rate, dilation=rate))
        self.n_rates = len(atrous_rates)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.permute(0, 3, 1, 2).to(cd)
        out = None
        for i in range(self.n_rates):
            conv = getattr(self, f"c{i}")
            y = F.conv2d(x, conv.weight.to(cd), conv.bias.to(cd),
                         padding=conv.padding, dilation=conv.dilation)
            out = y if out is None else out + y
        return out.permute(0, 2, 3, 1).float()
