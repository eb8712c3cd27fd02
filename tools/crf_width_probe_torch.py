"""Where the class count costs inside the fast CRF, on the PyTorch port
(counterpart of ``tools/crf_width_probe.py``): COCO's CRF question, asked of
kernel K5.

    python tools/crf_width_probe_torch.py [--device cuda] [--batch 16]
                                          [--size 448]

Runs ``ops.crf.mean_field_crf(fast=True, return_logits=True)`` on seeded
images and softmax posteriors at C 21, 32 and 81 classes, with the position
term on (``pos_w`` 1) and off (0), and prints the median ms of a call (CUDA
events) beside the card's name and power limit.  A fast CRF hands K5 C + 1
value columns (the posteriors and the cell count): V 22, 33 and 82.
``--device cpu`` runs the plain paths at a size shrunk with
``--batch``/``--size`` (the rehearsal convention of
``tools/crf_apply_experiment_torch.py``); its times mean nothing.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

CLASSES = (21, 32, 81)
POS_W = (1.0, 0.0)
ITERS = 5


def main(argv=None):
    """The table's rows: ``{"classes", "pos_w", "ms"}`` a configuration."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--size", type=int, default=448)
    args = p.parse_args(argv)

    from dupl_tpu_torch.ops import crf as crf_ops
    from dupl_tpu_torch.utils.device import cli_device
    from dupl_tpu_torch.utils.timing import card_line, time_ms

    device = cli_device(args.device)
    b, hw = args.batch, args.size
    g = torch.Generator().manual_seed(0)
    img = torch.rand(b, hw, hw, 3, generator=g).to(device)
    print(f"fast CRF at B {b}, {hw}^2 | {card_line(device)}")
    rows = []
    for c in CLASSES:
        probs = torch.softmax(torch.rand(b, hw, hw, c, generator=g), -1).to(
            device)
        for pos_w in POS_W:
            def call():
                return crf_ops.mean_field_crf(img, probs, fast=True,
                                              return_logits=True, pos_w=pos_w)
            ms = time_ms(call, device, iters=ITERS, warmup=1)
            rows.append({"classes": c, "pos_w": pos_w, "ms": ms})
            print(f"C={c:3d} pos_w={pos_w}: {ms:.3f} ms", flush=True)
        del probs
    return rows


if __name__ == "__main__":
    main()
