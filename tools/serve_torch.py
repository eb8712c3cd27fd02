"""Segmentation serving daemon on the PyTorch port (dupl_tpu_torch).

    # from a sealed artifact (tools/export_model_torch.py):
    python tools/serve_torch.py --artifact dupl_voc.duplsrv --port 8000
    # or live from training weights:
    python tools/serve_torch.py --weights ckpt/weights.npz --dataset voc --port 8000

    curl -s -X POST --data-binary @image.jpg -H 'Content-Type: image/jpeg' \
        http://127.0.0.1:8000/v1/segment > pred.png

Same HTTP contract and flags as ``tools/serve.py``: ``--artifact`` serves a
``.duplsrv`` of ``tools/export_model_torch.py`` (sealed for the device it
serves on), ``--weights`` a ``.npz`` written by the JAX package's
``checkpoint.export_weights`` live; plus ``--device`` (default ``cuda``).
Without a CUDA device the daemon refuses to start unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact",
                     help=".duplsrv file from tools/export_model_torch.py")
    src.add_argument("--weights", help="weights .npz (live mode)")
    p.add_argument("--dataset", choices=["voc", "coco"], default="voc",
                   help="config for --weights live mode")
    p.add_argument("--backbone", default=None)
    p.add_argument("--branch", default="ensemble")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch-delay-ms", type=float, default=10.0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch paths")
    args = p.parse_args()

    import dataclasses as dc

    import numpy as np
    import torch

    from dupl_tpu_torch.config import coco_config, voc_config
    from dupl_tpu_torch.engine.serve import (Batcher, InferenceSession,
                                             make_http_server)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to serve on the "
                         "CPU's plain PyTorch paths")
    if args.artifact:
        session = InferenceSession.from_artifact(args.artifact, device=device)
    else:
        cfg = voc_config() if args.dataset == "voc" else coco_config()
        if args.backbone:
            cfg = dc.replace(cfg, model=dc.replace(cfg.model,
                                                   backbone=args.backbone))
        branch = args.branch if args.branch == "ensemble" else int(args.branch)
        session = InferenceSession.from_weights(
            cfg, args.weights, device=device, batch_size=args.batch_size,
            branch=branch, merge="max" if args.dataset == "voc" else "sum")

    # build the kernels and warm up before accepting traffic, on the worker
    # thread that serves (cuBLAS and cuDNN create their handles per thread)
    batcher = Batcher(session, max_delay_s=args.max_batch_delay_ms / 1e3)
    batcher.submit(np.zeros((64, 64, 3), np.uint8)).result(timeout=600)
    server = make_http_server(batcher, args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(batch {session.batch_size}, crop {session.crop_size}, "
          f"{session.num_classes} classes, {device})", flush=True)

    # shutdown() must run off the serve_forever thread or it deadlocks
    signal.signal(signal.SIGTERM, lambda *a: threading.Thread(
        target=server.shutdown, daemon=True).start())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
