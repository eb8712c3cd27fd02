"""Instruction rate of the elementwise and transcendental instructions on the card
(the port's counterpart of ``tools/exp_rate_experiment.py``).

    python tools/exp_rate_experiment_torch.py [--device cuda] [--rows 512]
                                              [--cols 1024] [--iters 4096]

Kernel P4 (``csrc/exp_rate.cu``) makes ``--iters`` dependent passes of
``acc <- acc + f(x + acc * 1e-9)`` over a (rows, cols) tile held in
registers, in fp32 and in bf16 (packed bf16x2 instructions), for f in mul,
exp (``__expf`` / ``h2exp``), exp2 (``ex2.approx``), exp_min
(``exp(min(., 60))``), tanh (``tanh.approx``) and, in fp32 only, expf (the
accurate library function).  The tile never touches device memory inside the
loop, so the time is the rate of f's instructions.

Prints per type and f the median ms (CUDA events) and Gop/s (elements x
passes a second).  ``--device cpu`` runs the plain twin (a Python loop of
elementwise calls) on a tile shrunk with ``--rows/--cols/--iters``; its
times mean nothing.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

NAMES = ("mul", "exp", "exp2", "exp_min", "tanh", "expf")


def make_input(rows: int, cols: int, dtype, device, seed: int = 0):
    """x = N(0, 1) - 1, as the reference tool draws it."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(rows, cols, generator=g) - 1.0).to(dtype).to(device)


def run(device, rows: int = 512, cols: int = 1024, iters: int = 4096,
        names=NAMES, reps: int = 5, seed: int = 0, verbose: bool = True):
    """One record per (dtype, f): ``dtype``, ``name``, ``ms``, ``gops``."""
    from dupl_tpu_torch.ops import experiments
    from dupl_tpu_torch.utils.timing import card_line, time_ms

    device = torch.device(device)
    if verbose:
        print(f"device={card_line(device)}", flush=True)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        x = make_input(rows, cols, dtype, device, seed)
        for name in names:
            if name == "expf" and dtype != torch.float32:
                continue
            ms = time_ms(lambda: experiments.exp_rate(x, name, iters), device,
                         reps, warmup=1)
            gops = rows * cols * iters / (1e-3 * ms) / 1e9
            records.append({"dtype": str(dtype).split(".")[-1], "name": name,
                            "ms": ms, "gops": gops})
            if verbose:
                print(f"{records[-1]['dtype']:8s} {name:8s}: {ms:8.3f} ms -> "
                      f"{gops:8.1f} Gop/s", flush=True)
    return records


def main(argv=None) -> int:
    from dupl_tpu_torch.utils.device import cli_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--names", nargs="+", default=list(NAMES), choices=NAMES)
    args = ap.parse_args(argv)
    run(cli_device(args.device), args.rows, args.cols, args.iters,
        tuple(args.names))
    return 0


if __name__ == "__main__":
    sys.exit(main())
