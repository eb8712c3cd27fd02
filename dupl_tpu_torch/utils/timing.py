"""Timing helpers of the command-line tools."""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch


def time_ms(fn: Callable[[], object], device: torch.device, iters: int = 10,
            warmup: int = 2, back_to_back: bool = False) -> float:
    """Median milliseconds a call of ``fn``: CUDA events around one call on
    an idle card (its host time to enqueue included); with
    ``back_to_back``, around rounds of back-to-back calls (as many as take
    about 5 ms, at most 20) divided by their number, so that the host's
    time to launch a call hides behind the device's work, as on the main
    path.  The host clock on the CPU, where the number only shows that the
    path ran."""
    for _ in range(warmup):
        fn()

    def round_ms(reps):
        if device.type != "cuda":
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            return 1e3 * (time.perf_counter() - t) / reps
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    reps = (max(1, min(20, int(5.0 / max(round_ms(1), 1e-3))))
            if back_to_back else 1)
    return statistics.median(round_ms(reps) for _ in range(iters))


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (every
    time measured on a card is written beside them); ``"cpu"`` otherwise."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def dispatch_ms(call: Callable[[], object], device: torch.device,
                iters: int = 10) -> float:
    """Milliseconds a dispatch of ``call`` in steady state, as a serving
    loop keeps the device fed: one untimed call, then ``iters`` calls
    enqueued back to back and one synchronisation, on the host clock
    (``tools/bench_serve_torch.py``'s method)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    call()
    sync()
    t = time.perf_counter()
    for _ in range(iters):
        call()
    sync()
    return 1e3 * (time.perf_counter() - t) / iters
