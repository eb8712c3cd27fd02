"""Device choice of the command-line tools."""

from __future__ import annotations

import torch


def cli_device(name: str) -> torch.device:
    """The torch device a tool's ``--device`` names.  Exits when it names a
    card and there is none: the tools run on the card unless told
    ``--device cpu``.  On a card TF32 is switched off for matmuls and
    convolutions, as the comparisons with the reference assume."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU's plain PyTorch paths")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
