"""Timing helpers of the command-line tools."""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch


def time_ms(fn: Callable[[], object], device: torch.device, iters: int = 10,
            warmup: int = 2) -> float:
    """Median milliseconds a call of ``fn``: CUDA events around each call on
    a card (device time, not the enqueue); the host clock on the CPU, where
    the number only shows that the path ran."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (every
    time measured on a card is written beside them); ``"cpu"`` otherwise."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
