"""Serving-program throughput of the PyTorch port: the deployable MSC +
flip + CRF segmentation service (``dupl_tpu_torch/engine/export.py``) on the
ViT-B/16 dual student, live and sealed.

    python tools/bench_serve_torch.py [--batch 16] [--branch 1|2|ensemble]
                                      [--sealed] [--iters 10] [--device cuda]

Seeded random weights, one batch of random uint8 images at the recipe's
crop.  Measures the device program in steady state (one untimed call, then
``--iters`` calls enqueued back to back and one synchronisation:
``utils/timing.py:dispatch_ms``), the capacity of one card; host-side decode
and resize ride the server's worker threads and overlap it.  ``--sealed``
also seals the program (``export_serving``, weights baked in), writes and
reads it back as a ``.duplsrv`` file (``save_artifact`` / ``load_artifact``)
and measures the loaded program.  Prints the card's name and power limit,
then one JSON line an arm (``serving_live``, ``serving_sealed``; img/s).
``--device cpu`` runs the plain twins (a functional check: its times say
nothing about the card); ``--crop`` exists for that check alone
(``--device cpu --crop 64 --batch 2 --iters 1``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", choices=["voc", "coco"], default="voc")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--branch", default="1",
                    help="1 / 2 / ensemble (ensemble runs both students)")
    ap.add_argument("--no-crf", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sealed", action="store_true",
                    help="also measure the sealed artifact's program")
    ap.add_argument("--backbone", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crop", type=int, default=None,
                    help="override the recipe's crop size (for --device cpu)")
    args = ap.parse_args(argv)

    import dataclasses as dc

    import numpy as np
    import torch

    from dupl_tpu_torch.config import coco_config, voc_config
    from dupl_tpu_torch.engine.export import (export_serving, load_artifact,
                                              make_serving_fn, save_artifact)
    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import DualStudent
    from dupl_tpu_torch.utils.timing import card_line, dispatch_ms

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_serve_torch: no CUDA device (use --device cpu for a "
              "functional run)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(device), flush=True)

    cfg = voc_config() if args.dataset == "voc" else coco_config()
    if args.backbone:
        cfg = dc.replace(cfg, model=dc.replace(cfg.model,
                                               backbone=args.backbone))
    if args.crop:
        cfg = dc.replace(cfg, data=dc.replace(cfg.data, crop_size=args.crop))
    branch = args.branch if args.branch == "ensemble" else int(args.branch)
    kw = dict(scales=(1.0, 1.5, 1.25) if args.dataset == "voc"
              else (1.0, 1.25, 1.5),
              merge="max" if args.dataset == "voc" else "sum",
              branch=branch, crf=not args.no_crf)

    model = DualStudent(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    crop = cfg.data.crop_size
    images = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (args.batch, crop, crop, 3)).astype(np.uint8)).to(device)

    def report(tag, call, **extra):
        ms = dispatch_ms(call, device, args.iters)
        print(json.dumps({"metric": f"serving_{tag}",
                          "value": args.batch * 1e3 / ms, "unit": "img/s",
                          "ms_per_dispatch": ms, "batch": args.batch,
                          "branch": args.branch, "crf": not args.no_crf,
                          "device": str(device), **extra}), flush=True)

    fn = make_serving_fn(cfg, model, **kw)
    report("live", lambda: fn(images))

    if args.sealed:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "bench.duplsrv")
            t0 = time.perf_counter()
            exported, meta = export_serving(cfg, model, batch_size=args.batch,
                                            device=device, **kw)
            t1 = time.perf_counter()
            save_artifact(path, exported, meta)
            t2 = time.perf_counter()
            program = load_artifact(path)[0].module()
            t3 = time.perf_counter()
            size_mb = os.path.getsize(path) / 1e6
        with torch.inference_mode():
            report("sealed", lambda: program(images), artifact_mb=size_mb,
                   export_s=t1 - t0, save_s=t2 - t1, load_s=t3 - t2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
