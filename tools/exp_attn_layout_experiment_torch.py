"""Microbench of the exp-attention forward with the q scale folded into the
kernel (the port's counterpart of ``tools/exp_attn_layout_experiment.py``).

    python tools/exp_attn_layout_experiment_torch.py [--device cuda] [--b 64]
                                                     [--n 197 785 1765]

Both arms start from the (B, N, H, D) tensors a QKV projection produces and
end in a (B, N, H, D) output.  Arm A (current): the live path, an
elementwise pass that scales q and rounds it to bf16, then kernel K1
(``csrc/exp_attention.cu``).  Arm B (bnhd): kernel P2
(``csrc/exp_attention_bnhd.cu``) alone, which scales q as it loads it.  The
reference variant also saved the transposes to and from a (BH, N, D) layout;
K1 reads and writes (B, N, H, D) by strides already, so here neither arm has
any, and what is measured is the scale pass.  P2 is K1's kernel
(``csrc/attention_fwd.cuh``) with the scale applied to its q tile in shared
memory, so the two arms give the same bits.

B = 64, H = 12, D = 64, N = 197, 785, 1765.  Prints per N the median ms of
each arm (CUDA events), their ratio and the largest difference relative to
the largest output.  ``--device cpu`` runs the plain twins at shapes shrunk
with ``--b``/``--n``; its times mean nothing.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def make_inputs(b: int, n: int, device, seed: int = 0, h: int = 12,
                d: int = 64):
    """Unscaled q, k, v: (B, N, H, D) bf16 from a seeded normal."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, n, h, d, generator=g).to(torch.bfloat16)
                 .to(device) for _ in range(3))


def current(q, k, v, scale: float = 0.125):
    """Arm A: the scale pass, then K1 on a card or its twin on the CPU."""
    from dupl_tpu_torch.ops import attention, experiments

    qs = q * experiments.bf16_scale(scale)
    if q.device.type == "cpu":
        b = q.shape[0]
        out = attention.exp_attention_ref(*(attention._to_bhnd(x)
                                            for x in (qs, k, v)))
        return attention._from_bhnd(out.to(torch.bfloat16), b)
    return attention.exp_attention_cuda(qs, k, v)


def run(device, b: int = 64, ns=(197, 785, 1765), iters: int = 8,
        seed: int = 0, verbose: bool = True):
    """One record per N: ``n``, ``b``, ``current_ms``, ``bnhd_ms``, ``ratio``
    (current / bnhd) and ``max_rel_diff``."""
    from dupl_tpu_torch.ops import experiments
    from dupl_tpu_torch.utils.timing import card_line, time_ms

    device = torch.device(device)
    if verbose:
        print(f"device={card_line(device)}", flush=True)
    records = []
    for n in ns:
        q, k, v = make_inputs(b, n, device, seed)
        ta = time_ms(lambda: current(q, k, v), device, iters)
        tb = time_ms(lambda: experiments.exp_attention_bnhd(q, k, v), device,
                     iters)
        a = current(q, k, v).float()
        bb = experiments.exp_attention_bnhd(q, k, v).float()
        rel = ((a - bb).abs().max() / a.abs().max().clamp_min(1e-6)).item()
        records.append({"n": n, "b": b, "current_ms": ta, "bnhd_ms": tb,
                        "ratio": ta / tb, "max_rel_diff": rel})
        if verbose:
            print(f"N={n}: current {ta:7.3f} ms | bnhd {tb:7.3f} ms "
                  f"({ta / tb:.2f}x)  max-rel-diff {rel:.2e}", flush=True)
    return records


def main(argv=None) -> int:
    from dupl_tpu_torch.utils.device import cli_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--n", type=int, nargs="+", default=[197, 785, 1765])
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    run(cli_device(args.device), args.b, tuple(args.n), args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
