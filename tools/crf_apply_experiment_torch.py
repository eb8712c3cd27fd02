"""Microbench of the CRF full-resolution kernel-apply formulations (the
port's counterpart of ``tools/crf_apply_experiment.py``).

    python tools/crf_apply_experiment_torch.py [--device cuda] [--batch 16]
                                               [--size 448] [--stride 8]

Shapes are the fast CRF's final slice at batch 16, 448 x 448, pivot stride 8:
basis (16, 200704, 11), coef (16, 11, 3136), logc (16, 3136), vals
(16, 3136, 22).  Arms:

  plain     the tile loop in plain PyTorch (``crf_cuda.kernel_apply_ref``),
            which writes and re-reads the kernel matrix tile by tile;
  fp32 exp  kernel K5 (``csrc/crf_apply.cu``): k = bf16(exp(min(s, logc)));
  bf16 exp  kernel P3 (``csrc/crf_apply_bf16.cu``): k = exp(bf16(min(s,
            logc))) taken on packed bf16, the value product on the tensor
            cores.

The reference tool also sweeps the row-block size of its kernels; that is a
parameter of a sequential grid over a large on-chip memory and has no
counterpart here (both kernels fix 128 pixels a block), so there is no
sweep.  Prints ms per arm (CUDA events) and each kernel's largest difference
from the plain arm relative to the largest output.  ``--device cpu`` runs
the twins at shapes shrunk with ``--batch``/``--size``; its times mean
nothing.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

V = 22


def make_inputs(batch: int, n: int, ns: int, device, seed: int = 0,
                v: int = V):
    """The tool's seeded operands: basis ~ N(0, 1), coef ~ 0.1 N(0, 1),
    logc = -|N(0, 1)|, vals ~ N(0, 1), all fp32."""
    g = torch.Generator().manual_seed(seed)
    basis = torch.randn(batch, n, 11, generator=g)
    coef = torch.randn(batch, 11, ns, generator=g) * 0.1
    logc = -torch.randn(batch, ns, generator=g).abs()
    vals = torch.randn(batch, ns, v, generator=g)
    return tuple(x.to(device) for x in (basis, coef, logc, vals))


def run(device, batch: int = 16, size: int = 448, stride: int = 8,
        iters: int = 10, seed: int = 0, verbose: bool = True):
    """One record: the shapes, ``plain_ms``, ``fp32_ms`` (K5), ``bf16_ms``
    (P3), and each kernel's ``*_max_rel`` against the plain arm."""
    from dupl_tpu_torch.ops import crf_cuda, experiments
    from dupl_tpu_torch.utils.timing import card_line, time_ms

    device = torch.device(device)
    n, ns = size * size, (size // stride) ** 2
    if verbose:
        print(f"device={card_line(device)}", flush=True)
    ops = make_inputs(batch, n, ns, device, seed)
    rows = max(1, n // 8)   # the plain arm's tile: an eighth of the image
    t_plain = time_ms(lambda: crf_cuda.kernel_apply_ref(*ops, block_rows=rows),
                      device, max(1, iters // 5), warmup=1)
    ref = crf_cuda.kernel_apply_ref(*ops, block_rows=rows)
    scale = ref.abs().max().clamp_min(1e-6)
    rec = {"batch": batch, "n": n, "ns": ns, "v": V, "plain_ms": t_plain}
    if verbose:
        print(f"plain tile loop ({rows} rows a tile): {t_plain:9.2f} ms",
              flush=True)
    for key, label, fn in (
            ("fp32", "kernel, fp32 exp", crf_cuda.kernel_apply),
            ("bf16", "kernel, bf16 exp", experiments.kernel_apply_bf16)):
        t = time_ms(lambda: fn(*ops), device, iters)
        rel = ((fn(*ops) - ref).abs().max() / scale).item()
        rec[f"{key}_ms"], rec[f"{key}_max_rel"] = t, rel
        if verbose:
            print(f"{label}:                   {t:9.2f} ms  max-rel "
                  f"{rel:.1e}", flush=True)
    return [rec]


def main(argv=None) -> int:
    from dupl_tpu_torch.utils.device import cli_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=448)
    ap.add_argument("--stride", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    run(cli_device(args.device), args.batch, args.size, args.stride,
        args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
