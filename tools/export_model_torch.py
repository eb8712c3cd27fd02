"""Export the segmentation service of the PyTorch port (dupl_tpu_torch) as a
sealed serving artifact (``dupl_tpu_torch/engine/export.py``).

    python tools/export_model_torch.py --weights ckpt/weights.npz \
        --dataset voc --branch 1 --batch-size 8 --out dupl_voc.duplsrv

The artifact seals the serving program (multi-scale + flip, branch or
ensemble, the fast CRF) with ``torch.export``, the weights baked in; serve it
with ``tools/serve_torch.py --artifact dupl_voc.duplsrv``.  The flags of
``tools/export_model.py``, with ``--device`` (default ``cuda``) in place of
``--platform``: a program is sealed on the device it will serve on.  Without
a CUDA device the tool refuses to start unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", choices=["voc", "coco"], default="voc")
    p.add_argument("--weights", required=True, help="weights .npz from training")
    p.add_argument("--out", required=True, help="output .duplsrv path")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--branch", default="ensemble",
                   help="1 / 2 (the branch offline eval selected) or "
                        "'ensemble' (mean of both students' logits)")
    p.add_argument("--no-crf", action="store_true")
    p.add_argument("--scales", type=float, nargs="+", default=None)
    p.add_argument("--device", default="cuda",
                   help="the device the program is sealed for and will "
                        "serve on; 'cpu' runs the plain PyTorch paths")
    p.add_argument("--no-bake", action="store_true",
                   help="export a (params, images) signature instead of "
                        "baking the weights in")
    p.add_argument("--backbone", default=None,
                   help="override backbone (e.g. test_tiny_patch16 for smoke)")
    p.add_argument("--crop-size", type=int, default=None)
    args = p.parse_args(argv)

    import dataclasses as dc

    import torch

    from dupl_tpu_torch.config import coco_config, voc_config
    from dupl_tpu_torch.engine.export import export_from_config

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to seal the "
                         "program for the CPU's plain PyTorch paths")
    cfg = voc_config() if args.dataset == "voc" else coco_config()
    if args.backbone:
        cfg = dc.replace(cfg, model=dc.replace(cfg.model,
                                               backbone=args.backbone))
    if args.crop_size:
        cfg = dc.replace(cfg, data=dc.replace(cfg.data,
                                              crop_size=args.crop_size))
    # each reference evaluation script's merge protocol (engine/eval_seg.py)
    merge = "max" if args.dataset == "voc" else "sum"
    scales = tuple(args.scales) if args.scales else (
        (1.0, 1.5, 1.25) if args.dataset == "voc" else (1.0, 1.25, 1.5))
    branch = args.branch if args.branch == "ensemble" else int(args.branch)

    meta = export_from_config(
        cfg, args.weights, args.out, batch_size=args.batch_size,
        scales=scales, merge=merge, branch=branch, crf=not args.no_crf,
        device=device, bake_params=not args.no_bake)
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({size_mb:.1f} MB)")
    for k in ("platforms", "batch_size", "crop_size", "num_classes",
              "branch", "crf", "input", "output"):
        print(f"  {k}: {meta[k]}")


if __name__ == "__main__":
    main()
