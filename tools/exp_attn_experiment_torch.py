"""Microbench of the exp-attention forward against its ones-column variant
(the port's counterpart of ``tools/exp_attn_experiment.py``).

    python tools/exp_attn_experiment_torch.py [--device cuda] [--bh 768]
                                              [--n 197 785 1765]

Arm A (current): kernel K1 (``csrc/exp_attention.cu``), whose denominator is
a row sum of the fp32 e taken with scalar additions.  Arm B (ones-column):
kernel P1 (``csrc/exp_attention_ones.cu``), whose second tensor-core product
contracts bf16(e) with ``[V | 1]`` and so yields the numerator and the row
sum together; the denominator then carries the numerator's bf16 rounding.

Shapes are the three CAM scales at inference batch 16 (x2 flip, x2 branch
folded into the batch): BH = 64 * 12, D = 64, N = 197, 785, 1765.  Prints per
N the median ms of each arm (CUDA events), their ratio and the largest
difference relative to the largest output.  ``--device cpu`` runs the plain
twins at shapes shrunk with ``--bh``/``--n``; its times mean nothing.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def make_inputs(bh: int, n: int, device, seed: int = 0, d: int = 64):
    """q (pre-scaled by 1/8), k, v: (BH, N, D) bf16 from a seeded normal."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(bh, n, d, generator=g) for _ in range(3))
    return ((q * 0.125).to(torch.bfloat16).to(device),
            k.to(torch.bfloat16).to(device), v.to(torch.bfloat16).to(device))


def current(q, k, v):
    """Arm A on (BH, N, D): kernel K1 on a card, its twin on the CPU."""
    from dupl_tpu_torch.ops import attention

    if q.device.type == "cpu":
        return attention.exp_attention_ref(q, k, v).to(torch.bfloat16)
    return attention.exp_attention_cuda(
        q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2)).squeeze(2)


def run(device, bh: int = 64 * 12, ns=(197, 785, 1765), iters: int = 20,
        seed: int = 0, verbose: bool = True):
    """One record per N: ``n``, ``bh``, ``current_ms``, ``ones_ms``,
    ``ratio`` (current / ones) and ``max_rel_diff``."""
    from dupl_tpu_torch.ops import experiments
    from dupl_tpu_torch.utils.timing import card_line, time_ms

    device = torch.device(device)
    if verbose:
        print(f"device={card_line(device)}", flush=True)
    records = []
    for n in ns:
        q, k, v = make_inputs(bh, n, device, seed)
        ta = time_ms(lambda: current(q, k, v), device, iters)
        tb = time_ms(lambda: experiments.exp_attention_ones(q, k, v), device,
                     iters)
        a = current(q, k, v).float()
        b = experiments.exp_attention_ones(q, k, v).float()
        rel = ((a - b).abs().max() / a.abs().max().clamp_min(1e-6)).item()
        records.append({"n": n, "bh": bh, "current_ms": ta, "ones_ms": tb,
                        "ratio": ta / tb, "max_rel_diff": rel})
        if verbose:
            print(f"N={n}: current {ta:7.3f} ms | ones-col {tb:7.3f} ms "
                  f"({ta / tb:.2f}x)  max-rel-diff {rel:.2e}", flush=True)
    return records


def main(argv=None) -> int:
    from dupl_tpu_torch.utils.device import cli_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bh", type=int, default=64 * 12)
    ap.add_argument("--n", type=int, nargs="+", default=[197, 785, 1765])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    run(cli_device(args.device), args.bh, tuple(args.n), args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
