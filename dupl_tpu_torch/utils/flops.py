"""FLOP counts and model FLOPs utilisation (counterpart of
``dupl_tpu/utils/flops.py``).

The count is ``torch.utils.flop_counter.FlopCounterMode`` around one call:
model FLOPs of the matmuls, convolutions and einsums the call dispatches,
backward included when the call runs one.  The port's kernels are
``dupl::`` ops (``ops/library.py``), each registered with a flop formula
equal to what the counter counts for its plain twin (for the attention ops:
for exact softmax attention and its autograd backward), so a step counts
the same on the card as on the CPU.  Elementwise work is not counted.

MFU = FLOPs / wall-clock seconds / the card's dense bf16 peak.  The peaks
are NVIDIA's published ones; this table is the one place the port keeps
them (``chip_smoke.py``'s bounds read it too).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _hopper(bf16: float, fp32: float, hbm_bytes_per_s: float) -> Dict[str, float]:
    """A Hopper card's rates.  An SM runs fp32 FMAs on 128 lanes (two
    FLOPs an instruction) and special-function instructions (exp) on 16."""
    return {"bf16": bf16, "fp32": fp32, "fp32_instr": fp32 / 2,
            "sfu": fp32 / 2 / 8, "hbm_bytes_per_s": hbm_bytes_per_s}


# Dense rates (no sparsity) from NVIDIA's H100 Tensor Core GPU datasheet,
# keyed by a lower-case part of torch.cuda.get_device_name().
_RATES = {
    # H100 SXM5 80 GB: 989 TFLOP/s bf16 (1,979 with sparsity), 67 TFLOP/s
    # fp32, HBM3 at 3.35 TB/s
    "h100 80gb hbm3": _hopper(989e12, 67e12, 3.35e12),
    # H100 PCIe 80 GB: 756 TFLOP/s bf16 (1,513 with sparsity), 51 TFLOP/s
    # fp32, HBM2e at 2.0 TB/s
    "h100 pcie": _hopper(756e12, 51e12, 2.0e12),
}

# The SXM part's rates, for a caller that must bound a card not in the table
H100_SXM = _RATES["h100 80gb hbm3"]


def device_rates(name: str) -> Optional[Dict[str, float]]:
    """The peak rates of the card called ``name`` (as
    ``torch.cuda.get_device_name`` gives it): ``bf16`` and ``fp32`` FLOP/s,
    ``fp32_instr`` and ``sfu`` instructions/s, ``hbm_bytes_per_s``; None
    for a card not in the table."""
    name = name.lower()
    for key in sorted(_RATES, key=len, reverse=True):
        if key in name:
            return dict(_RATES[key])
    return None


def peak_flops_per_device(device) -> Optional[float]:
    """Dense bf16 peak FLOP/s of a CUDA device (a ``torch.device`` or its
    string), by its name; None for the CPU or a card not in the table,
    where MFU means nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    rates = device_rates(torch.cuda.get_device_name(device))
    return None if rates is None else rates["bf16"]


def count_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one call ``fn(*args, **kwargs)`` as ``FlopCounterMode``
    counts them, backward included when ``fn`` runs one."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def mfu(flops_per_call: Optional[float], calls: int, seconds: float,
        device) -> Optional[float]:
    """Model FLOPs utilisation in [0, 1]; None when either side is
    unavailable."""
    peak = peak_flops_per_device(device)
    if not flops_per_call or not peak or seconds <= 0:
        return None
    return flops_per_call * calls / seconds / peak
